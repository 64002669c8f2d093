#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error.
They run in this order, but for two groups that run beside others in a
process of their own (``Spawned``), so that only work that times nothing
or quotes no figure the card's tables hold runs beside another phase:
phases 5 and 6 beside phase 8 and phase 9's first parts (the gaps and
the strings, which time nothing; ``serve_phases``), and phases 12-14
beside phases 10, 11 and 15, whose loops wait on their actors
(``phases_beside``). Phases 3, 4, 7 and the timed parts of 9 run with
nothing of the script beside them.
Each phase reads its launch counts from zero in the process that runs it.
The script is the child subreaper of every process it starts: at its end,
and at the end of each ``Spawned`` job, whatever still runs below it is
killed, reaped and named on stderr.

1. device  — print the card's name and power limit; TF32 off for matmuls
             and cuDNN convolutions, so the parity phases compare f32.
2. build   — compile every CUDA kernel from ``distar_tpu_torch/ops/csrc``
             (one nvcc per source, in parallel) and print the seconds.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the flagship serve shapes (32 slots, 512 entities) and at edge
             cases: attention in f32 and bf16 over head dims 4-128, 1-512
             keys, prefix and non-prefix masks, and masked K/V rows at
             +-1e4; the two scatter kernels bit-equal to the entity-order
             loop and to each other on uniform, padded and one-cell indices,
             and the loop kernel in bf16 bit-equal to the bf16 loop; kernel,
             plain and library times (attention in both dtypes), each the
             device time per call read from torch.profiler, beside a bound
             restated for the units the kernel runs on.
4. serve   — the flagship model (``default_model_config`` with the kernel
             overlay, full width, seeded random weights) behind
             ``BatchedInference(32 slots) -> BatchedInferenceEngine ->
             InferenceGateway``: 8 sessions x 3 steps plus a reset, once per
             scatter kernel, with the launch counts read around each run;
             then the kernel-backed forward held against the 'xla' strings on
             the same weights and Gumbel noise, and the median flush time.
5. serve_process — the serving process, flagship with the kernel overlay,
             f32, 32 slots, observations from a generator of its own:
             seeded weights written by the port's
             ``save_checkpoint`` as a learner checkpoint (v1, and v2 from
             another seed), verified, a byte-flipped and a truncated copy
             refused; the stack as ``bin/serve.py`` builds it (registry from
             the checkpoint, HTTP and TCP frontends): 8 sessions x 3 steps
             through ``ServeClient.act_many``, the teacher (v2) installed over
             TCP and asked for by half the lanes, one HTTP act, status and
             ``/metrics``; every output bit-equal to an in-process gateway
             given the same weights, seed and request order, teacher logits
             against ``teacher_step``, launches equal to the flushes derived
             from the script, ``/metrics`` counting the requests; a TCP hot
             swap to v2 and a swap under traffic; the wire's timings, with
             the serialization of one 32-lane request and answer; then
             ``python -m distar_tpu_torch.bin.serve`` as a process (started
             with the phase, it boots beside the in-process stack; a thread
             times its first answer), one act, SIGTERM, exit 0. The wire is
             TCP only here.
6. serve_fleet — the serving fleet on the same model and checkpoints,
             observations from a generator of its own: a ``CoordinatorServer``
             in process; gateway A, the stack ``bin/serve.py`` builds, in
             process and registered with a deregister hook (its launches are
             read from zero around the fleet script); gateway B,
             ``python -m distar_tpu_torch.bin.serve --coordinator-addr`` as a
             process on the same card. a. the native shuttle: crc32 against
             zlib, the LZ4 codec round-tripping a 32-lane answer, the plain
             decoder on its stream, the native decoder on ``lz4_block``'s. c. a
             ``FleetClient`` discovers both and runs ``serve_script``: each
             session on its ``HashRing`` owner, every answer bit-equal to an
             in-process gateway fed that gateway's sessions in order. d.
             ``FleetRollout``: a canary of v2 on B (new sessions split by the
             hash, existing ones unmoved), promote, then a rollout of a
             missing checkpoint that NACKs and changes nothing. e. SIGTERM to
             B under traffic: it leaves discovery within one refresh, exits 0,
             its sessions migrate to A (counted), no request fails. f. a
             32-lane ``act_many`` against A in process, over TCP (``DTL0``) and
             over shared-memory rings sized from the answer, median of 5 in
             turns, the shm row failing on any fallback to TCP; the
             encode/decode split. b'. (before e.) fleet health: both gateways
             ship their snapshots and request traces to the coordinator every
             FLEET_SHIP_S (B as ``bin/serve.py --telemetry-interval-s``, A
             through the ``TelemetryShipper`` ``bin/serve.py`` starts); its
             ``/healthz`` lists both sources fresh, ``/traces`` holds request
             traces of both, and ``/trace/<id>`` of B's slowest returns a
             waterfall with its critical path; A's ship ms and bytes.
7. train   — the SL train step at flagship width and depth, f32, batch 2 x
             unroll 32 (64 frames): each kernel's autograd Function at the
             training shapes, its forward (the kernel) against the plain
             version and its backward (the JAX formula) against autograd
             through the plain version (attention f32 and bf16, both
             scatter kernels bit for bit); one
             step per config string ('pallas', 'pallas_onehot', 'xla') from
             the same weights, batch and state, agreeing on loss, info and
             grad_norm; 8 steps of ``bin/sl_train.py``'s learner on one fixed
             batch, the loss falling and 3 attention + 1 scatter launches a
             step; step ms, SL frames/s, a profiled step, peak memory and
             each kernel's forward and backward at the training shapes; one
             bf16 step. Beside each kernel at the training shapes, the library
             calls of the same functions: SDPA with the same boolean mask
             (forward, forward + backward; f32 and bf16), ``zeros +
             index_add_`` and an ``index_select`` gather for its backward.
8. sl_runtime — the SL learner runtime at the flagship (kernel overlay, f32,
             2 x 32): a train set (6 x 40 steps) and a held-out set (2 x 40)
             of ``random_sl_batch`` steps written with ``ReplayDataset.save``,
             with the bytes a step, the write time, one batch's collation and
             its host-to-device copy (pinned, pageable); ``python -m
             distar_tpu_torch.bin.sl_train --data --eval-data`` as a process
             (the flagship's widths at depth 1, ``shallow``: it checks
             plumbing; on a thread, joined once phase 9's first parts are
             done) under 'pallas_onehot' for 8 steps (a checkpoint every 4, EVAL
             every 4): exit 0, finite log lines, the pointer's generations
             newest first and verified, its launches read from its output;
             the same command again, SIGTERM after its next periodic
             checkpoint (the crash save lands and the pointer names it),
             restarted (it resumes there), then its newest generation torn
             (the next start falls back a generation and counts it); in
             process under 'pallas' on the dataset's first 8 batches: A and
             A' train them straight, B too with a sync save after 4, C
             restores B bit-equal (params, mu, nu, count), its first loss
             equal to B's fifth (one state, one batch), its losses and
             parameters held against A within twice the envelope of A, A'
             and B (the card's backward does not repeat bit for bit); prefetch
             depth 2 against 0 through ``run()`` on the same batches (placed
             batches bit-equal to the host ones, each run held against A the
             same way, step and data-wait ms, a profiled step); the async save (the loop's blocked time against the
             write), a sync save and a restore; the admin API's status,
             save_ckpt (landing at the next boundary) and profile (one
             step captured, its ranked buckets, its device time within 10%
             of torch.profiler's busy time) during a run; ``evaluate`` on
             the held-out set.
9. rl      — the RL learner (``RL_LEARNER_DEFAULTS``, 4 x 16: 68 observed
             frames) and the distillation student at flagship width, f32.
             Its first parts, the gaps and the strings, time nothing: beside
             them phases 5 and 6 and phase 8's processes run on and phase
             10's e. and phase 11's smoke-model runs run, all joined before
             the rest. Then
             each kernel's Function at the RL shapes [68, 2, 512, 128] /
             [68, 512, 32] and the student's [68, 2, 512, 64] / [68, 512,
             16], held as in phase 7 and timed beside the library calls; the
             readings of the strings' gradient gap (``rl_gap``: repeat,
             mixed strings, intermediates, an f64 yardstick, the ReLU and
             max-pool kinks and UPGO's step) on the phase's batch and a
             seed-0 batch, held (on zero observations, printed, until the
             learner diagnostics came); the
             three config strings from the same weights on a zero-observation
             ``FakeRLDataloader`` batch and on a fixed ``random_rl_batch``:
             loss and every info scalar within STEP_TOL, the whole gradients
             within GRAD_TOL of their norm, while planted wiring faults
             (UPGO or KL term dropped, time and batch axes crossed) must
             move the 'xla' gradient further than GRAD_TOL; printed beside
             them the 'xla' string's distance from its own repeat and the
             parameter groups that carry the strings' distance; then one
             step each; one step
             with the value-pretrain gate (the policy heads bit for bit
             unchanged, the winloss tower moved); 8 steps of
             ``RLLearner.run`` on its own ``FakeRLDataloader`` with 3
             attention + 1 scatter launches a step; step ms, RL frames/s, a
             profiled step, peak memory; one bf16 step; 3 steps at the
             reference's 6 x 64 with their peak memory; the
             ``DistillLearner`` strings held the same way, 4 steps of
             ``DistillLearner.run`` with 2 attention + 1 scatter launches a
             step, and its step ms. The learner diagnostics on the strings'
             learners (``phase_diagnostics``; ``python3 chip_smoke.py --only
             diagnostics`` runs them alone): d. the training-dynamics tree
             of the 'pallas' learner's first step: its keys those of the
             smoke model's RL step on the CPU (the CPU tests' set), every
             norm within TREE_TOL of a float64 recomputation per module on
             the card (parameters, the gradient of its own autograd pass,
             the first Adam update), its census 0, and as many
             synchronizing calls a step with the tree as without
             (``device_pure_report``); e. ``step_times`` with the tree off
             and on (the monitor at every_n 10), in turns, 3 each, the
             medians printed; g. ``POST /learner/profile?steps=2`` to the
             learner running ``run()`` with its admin route: the report's
             buckets ranked, entity-attention and scatter above 0, shares
             summing to 1 within 1e-5, its device time within 10% of
             torch.profiler's busy time for the same steps; h.
             ``distar_perf_flops_per_step`` equal under the 'pallas' and
             'xla' strings (their learners count, ``learner.perf.aot``; the
             script's other learners do not, ``DISTAR_PERF_AOT=0``),
             ``distar_perf_mfu`` printed, the HBM gauges those of
             ``torch.cuda.memory_stats()``. Their seconds are in the
             ``phase seconds`` line.
10. rl_loop — the league-RL loop of ``bin/rl_train.py --type all`` at the
             flagship (kernel overlay, f32), built by ``rl_train.build_all``:
             tests/test_pipeline.py's league (PFSP, MP0 against HP0), an
             in-process coordinator, the actor on 8 mock envs of 300 game
             loops with trajectories of 16 steps (weights refreshed every
             second), the RL learner on 4 x 16 batches of the actors'
             trajectories for 2 iterations (8 before phase 11 came, 4
             before the learner diagnostics, 3 before the parallel phase;
             cut to keep the script in its time),
             publishing its weights and its
             train-info every 2 (the launcher's 4 replaced by attaching the
             weight plane again). a. one actor job alone on a thread. b. the
             loop: the actor's job loop on the supervisor's thread, the
             learner on the main one, each kernel's launches counted from
             zero for each side (``ThreadCounts``) and read when the
             learner's run ends, then one learner step profiled while the
             actor runs. c. every batch made of the
             actors' trajectories, finite losses, the league's games, ELO,
             payoff and train steps, two or more publications loaded, the
             actor's policy weights bit-equal to the learner's at the
             publication it loaded (at a job's start and at each refresh),
             every kernel launched on both sides. d. one captured loop flush
             (half its lanes or more acting) re-run on the 'xla' strings
             (SERVE_TOL), and the RL loss on an actor-made batch held across
             the strings (``hold_strings``; where the unpinned gradient reads
             above GRAD_TOL, the batch is saved under ``chiprun_out/`` and
             held by the probe instead: ``hold_loop_batch``, ``rl_gap`` with
             every kink pinned, GAP_TOL; one flagship learner switched
             between the strings, ``OneLearner``). e. on a thread beside
             phase 9's first parts, ``bin/rl_train.py`` as four processes
             (the flagship's widths at depth 1): coordinator, league,
             a learner of 4 steps (exit 0, ``learner done``) and an actor
             (SIGTERM: exit 0; no traceback in the actor's log, while the
             coordinator and league may report its hang-up, as the JAX
             servers do), with fleet health on as the JAX defaults give it,
             the learner and actor shipping every second. Check a: before
             the SIGTERMs the coordinator's ``/healthz`` is 200 and ok with
             the learner's and the actor's sources fresh (503 where the
             reference's ``learner_mfu_collapse``, the one rule allowed,
             fires: where the learner's ``distar_perf_mfu`` reads under
             2%), ``/timeseries`` shows the learner's iterations rising,
             ``/traces?name=trajectory`` a trajectory the learner
             shipped, and its ``/trace/<id>`` waterfall carries the actor's
             push and the learner's collate; after them the coordinator and
             the actor, not the league, have left one flight bundle each
             (the signal event, a registry snapshot). c'. (after c., on the
             loop's learner and actor, ``phase_health``) the fleet-health
             fault drill, each fault under an ``init_fleet_health(
             default_rulebook(("learner", "actor"), stall_window_s=2.0),
             sample_interval_s=0.1, eval_interval_s=0.2)`` of its own and an
             in-process ``CoordinatorServer``. With the actor idle,
             ``ChaosInjector.poison_module(learner, "core_lstm", n=3)`` over
             3 steps of ``run()`` on an actor-made batch (the tree exported
             every step): ``learner_loss_nonfinite`` and
             ``learner_grad_nonfinite`` fire exactly once each (and of the
             learner's numeric and perf rules only they, and
             ``learner_mfu_collapse`` where MFU reads under 2%),
             ``learner_grad_nonfinite``'s exemplar is
             ``blackbox:<bundle>``, the one black-box bundle of the poisoned
             steps (f.: its capture ms and bytes printed, and
             ``python -m distar_tpu_torch.tools.stepreplay`` replays it on
             the card as a process: ``ok``, non-finite reproduced,
             provenance confirmed, bit for bit; ``python -m
             distar_tpu_torch.tools.opsctl dynamics --dir`` lists it and
             ``--inspect`` names the port's stepreplay, exit 0 each, as the
             JAX ``opsctl`` exits on the same directory), ``/healthz`` answers 503
             while they fire, a ``dump`` holds the transitions and the NaN
             ``distar_learner_loss``; the learner state from before the
             poison put back, 3 clean steps, both rules ok.
             With the learner idle, the actor's job loop a ``Supervisor``
             task with ``AlertRemediator(supervisor, {"actor_env_starvation":
             "actor"})`` as ``--type all`` runs it, and every mock env's next
             step delayed 3 s (``ChaosInjector.wrap`` patched over
             ``MockEnv.step``): the rules evaluated once a 2 s window is
             sampled, then nothing fires over a window of steady steps, and
             ``actor_env_starvation`` fires exactly once after the stall
             (a job's start, the only gap in a running actor's env steps,
             lasts about as long as the 2 s window, so the actor's first job
             is under way before the stall), the task restarts
             exactly once (one remediation, one ``task_restart``), env steps
             resume; each kernel's inputs captured from the learner's first
             clean step and the restarted actor's first flush against the
             plain versions; launches by thread, read once the actor's
             last job is over, exactly one attention call a layer and one
             scatter a step and twice that a flush (policy and teacher).
             Printed: ship ms and bytes (learner, actor), the coordinator's
             ingest ms, its store's series and sources, ``/healthz`` ms,
             seconds to each firing and to the restart, dump s and bundle
             bytes, step and flush ms beside the phase's alone, without
             fleet health. ``python3 chip_smoke.py --only health`` runs c'.
             alone after the build, on a learner and actor built as c'.
             finds them and on the batch it gets (``health_loop``), then
             times the step with no fleet health, sampled every 1 s and
             every 0.1 s, in turns (``sampler_ab``). Printed: env steps/s, frames/s
             made and consumed, flush and step ms in the loop and alone,
             data wait, publish and refresh ms, trajectory push ms and
             bytes, peak memory, the profiled step's idle share.

11. replay — the replay store between actors and learner, as
             ``bin/rl_train.py --type all --replay`` builds it
             (``rl_train.build_all``) at the flagship (kernel overlay, f32):
             rl_loop's league, actor (8 mock envs of 300 game loops,
             trajectories of 16) and learner (4 x 16, 2 iterations, 4 until phase
             15 came; prefetch
             depth 2), and between them one ``ReplayServer`` on loopback,
             transport auto (its rings sized for a flagship trajectory where
             /dev/shm has room), sampler uniform, samples-per-insert 4, spill
             on. Checked: the store's inserts are the actor's acknowledged
             pushes; its samples the learner's 8 and at most what the
             prefetcher drew ahead; the limiter's ratio within its buffer at
             every insert and sample; every sampled trajectory bit-equal to
             one pushed (a sha256 of its leaves a push); both kernels
             launched on both sides (``ThreadCounts``), and on one call's
             inputs captured from each side against their plain versions;
             the spill's live blobs the unsampled items, recovered by a new
             store; one step on a store-sampled batch across the strings
             (``steps_agree``, one learner switched between the strings and
             put back between them). Then, on the smoke model, beside phase
             9's first parts: on a thread, the
             roles as processes (``--type replay`` on a spill directory, an
             actor on ``--replay-addr``, the store SIGKILLed with four
             acknowledged, unsampled inserts and restarted on its port and
             directory, recovering the four; a learner of 2 steps; SIGTERM
             exit 0 each); in a process of its own (``Spawned``),
             ``--replay-shards 2`` and ``--replay-fast-path`` runs,
             ``bin/sl_train.py --remote`` fed by an in-script
             ``ReplayActor`` with a stub decoder, 4 steps; ``bin/play.py
             --game_type mock``, 2 games. Printed: inserts, samples, reuse
             against spi, the learner's data wait a batch beside rl_loop's,
             frames made and consumed a second, step and flush ms in the loop
             beside alone, insert, sample and spill-append ms, bytes a
             trajectory, recovery count and seconds, the in-loop step's idle
             share and peak memory.

12. anakin — ``bin/rl_train.py --anakin --env jaxenv`` at the flagship
             (kernel overlay, f32), through ``rl_train.build_anakin``: the
             micro-battle world (4 units a squad, episodes of 32 steps) on
             16 lanes x 16 steps a window, the learner (256 acted frames a
             step, no prefetch) on 3 windows; the first window under the
             purity report (no host read, no synchronizing call). Checked:
             3 finite steps; each kernel's launches per window (a forward a
             step: one attention per transformer layer and one scatter) and
             per learner step, all on the main thread; one call's inputs
             captured in a window and in a learner step against the plain
             versions; a steady-state window under
             ``torch.cuda.set_sync_debug_mode("error")`` with no
             ``Memcpy HtoD``/``DtoH`` activity in its profile, the finished
             lanes read after it; the away seat (a frozen copy of the
             initial policy) for 2 windows, every lane's episode drained into
             results, its batches of the single-policy layout;
             ``head_to_head`` of the flagship ``ModelPolicy`` against
             ``attack_nearest_policy`` and of that against ``idle_policy``
             over 16 episodes, each the full dict. In a process of its own
             from the start of phases 12-14, ``--type all --env jaxenv`` on
             the smoke model (the host env on the card) for 2 iterations.
             Printed:
             window s and env steps/s, ms a step in the window and a
             16-lane forward alone beside rl_loop's flush, learner step ms,
             the idle share of a window and of a step, peak memory,
             head-to-head s, the phase's s.

13. league — the league economy at the flagship with value towers (kernel
             overlay, f32) at docs/league.md's quickstart sizes (2 lanes x 3
             steps, 2 units a squad, episodes of 8 steps). a. ``rl_train
             --type league-run --league-players MP0,EP0,ME0 --league-rounds
             1 --league-actors-per-player 1`` as a process (the quickstart's
             2 rounds cut to 1 to keep the script in its time), journaled
             to its default ``<save-path>/league_journal``: three learner
             processes on the card; exit 0, ``LEAGUE-RUN-DONE`` with
             ``ok``, every learner at rc 0, a snapshot minted, an
             off-diagonal payoff cell with games, no orphaned job, each
             learner's first window pure and its round shown, each fleet
             ``actors-<player>`` holding one member and drained to none;
             while it runs, ``python -m distar_tpu_torch.tools.opsctl``
             ``status``, ``league`` and ``arena`` against its coordinator
             (``--port``), each exiting as the JAX ``opsctl`` does (status:
             0, 1 or 2 as the ``status`` it printed; the others 0).
             Then, in this process with no learner running, the journal
             cold-booted by an ``HAState`` (its final snapshot) and replayed
             record by record from its first: both digests equal the run's;
             the records, the journal's bytes, the replay seconds and a
             durable (fsync'd) and a flushed append's ms on this disk.
             b. ``--type coordinator --arena-store --journal-dir`` (the
             primary), a second ``--ha-role standby --ha-peers <primary>``
             beside it, and ``--type arena`` (MP0's lineage of a., 3
             batches of 8 episodes) as processes on the address list of
             both: exit 0, both anchors and an MP0 generation rated, the
             artifact written, the last batch resent (all duplicates); the
             primary SIGKILLed, the standby promoted within its takeover
             grace (the seconds printed), serving the same ratings, and the
             resent batch deduplicated there too. a. and b. run on a thread
             from the start of phases 12-14 (``league_processes``): their
             seconds and the used memory are read beside the Anakin loop and
             phases 10 and 11, not on an idle card. c. in
             this process, against a control
             plane of the phase whose one historical player is MP0's newest
             generation of a.: one league learner (``build_league_learner``,
             EP0, its away seat that generation loaded with
             ``load_params``) for one round, then one
             ``ArenaEvaluator.evaluate_once`` of MP0's generations against
             ``attack_nearest``. Checked: launches per window (home and
             away seat), per learner step and per arena batch, all on the
             main thread; one call's inputs captured from the home seat,
             the away seat, the learner step and the arena batch against
             the plain versions. Printed: league-run s and each learner's
             s from spawn to exit, the card's used memory during it, window
             and step ms beside the anakin phase's, ask, report and
             train-info ms, save s, peak memory, arena s a batch and
             matches/s, the phase's s. ``python3 chip_smoke.py --only
             league`` runs this phase alone (after the build), a. and b.
             first.

14. parallel — ``parallel/`` as a world of one, on the rl phase's batch.
             a. an NCCL process group of one (backend, world size,
             ``torch.cuda.nccl.version()``; an ``all_reduce`` gives its
             input back). b. the flagship RL learner (kernel overlay, f32,
             4 x 16) under ``make_mesh(MeshSpec(dp=1))``, one step from the
             weights, batch and optimizer state of two unmeshed repeats:
             the loss, every info scalar, the grad norm and the parameters
             within twice the repeats' envelope (or 1e-6 relative where
             they agree to the bit); 3 attention and 1 scatter launches,
             read from zero; step ms, median of 3, beside the unmeshed. c.
             its sharded checkpoint (params, mu, nu, count: 506 MB): a sync
             save, ``verify_checkpoint``, a restore into an unmeshed learner
             bit-equal; one flipped byte fails the generation and
             ``resume_latest`` falls back a generation; the bytes, save
             and restore s, and an async save's blocked time against its
             write. d. 3 iterations of ``run()`` through ``ShardFeeder`` at
             depth 2: the placed batches bit-equal to the host ones, the
             mean wait against the step ms, the ``distar_feeder_*``
             counts. e. ``Attention(impl='ring')`` at sp=1 at [68, 2, 512,
             128] against 'pallas' and 'xla', and its backward against
             autograd through the plain version, within ATTN_TOL. f. the
             executor's kill and resume at the smoke model, beside phases
             13 and 14, as ``python -m distar_tpu_torch.tools.chaos
             multichip-drill --mesh dp=1 --resume-mesh dp=1 --host-devices
             0 --iters 2 --kill-after 1`` (the executor killed with 137
             after its sharded save at iteration 1, resumed from that
             generation to 2: ``finished unassisted``, the verdict's keys,
             the newest generation sharded and verified). g. two gloo
             ranks on the one card (``spawn_ranks(..., device="cuda")``:
             NCCL refuses two ranks a device), started with phase 13
             (``mesh_rank_processes``): the flagship RL learner (kernel
             overlay, f32, 4 x 16, six value towers) unmeshed on each
             rank (the single-process reference in the ranks' own
             processes, and its repeat), then under dp=2 (the rows split,
             no parameter: the yardstick), fsdp=2 and tp=2, two steps each
             on the rl phase's batch, with deterministic algorithms in
             both ranks (``torch.use_deterministic_algorithms``: the
             repeat then reads 0; the ops without a deterministic version
             are listed). Held at fixed bounds against the reference:
             dp=2, fsdp=2 and tp=2 each, and fsdp=2 against dp=2 (the same
             rows on the gathered parameters): the first step's forward
             scalars at the tolerances of tests/test_torch_parallel_ranks.py
             (1e-5 of max(1, |v|)), what reads a gradient (the first
             step's gradient scalars and parameters, the second step, the
             moments) within GRAD_TOL relative (Queue 3 items 1 and 72);
             fsdp=2 against dp=2's first step at the tests' tolerances
             throughout. Each rank's 3 attention and 1 scatter launches a
             step, read from zero, the heads the attention saw (1 of 2
             under tp=2), the attention kernel against its plain version
             on the first call's inputs of each run (under tp=2 [68, 1,
             512, 128]) within ATTN_TOL of the output's scale (max(1, max
             |plain|), as SCATTER_TOL on real sums), the six gloo
             collectives on CUDA tensors each checked once, its blocks'
             elements, its ``memory_allocated`` between steps and its peak
             during one beside the world of one's, and its step ms (over
             gloo, which stages CUDA collectives through the host: no
             speed figure); the perf monitor's flops_per_step, implied
             TFLOP/s and MFU of the unmeshed and the tp=2 rank's own step
             (the learner's meta copy placed on its mesh), the tp=2 rank's
             flops below the unmeshed step's; every reading is printed
             before one is checked.
             ``python3 chip_smoke.py --only parallel`` runs this phase
             alone.

15. sc2 — the SC2 side over a fake install (``fake_sc2.write_fake_install``
             in the script's temp dir: ``Versions/Base75689/SC2_x64`` runs the
             port's fake binary; ``SC2PATH`` points at it). b. the flagship
             (kernel overlay, f32) in an ``Actor`` on ``make_sc2_env`` with
             ``player_ids [agent, bot7]``: one fake process launched through
             ``run_configs`` and ``sc_process``, one job of SC2_EPISODE_LOOPS
             game loops, its trajectories pushed; launches exactly one
             attention a layer and one scatter a policy flush and a teacher
             forward, read from zero around the job. Its weights come from a
             reference-layout ``.pth``: the seeded policy written through
             ``ref_convert.reference_state_dict`` and loaded through
             ``bin/play.load_params`` (``ref_convert.convert_model``, then
             the weight bridge), bit for bit the seeded state dict; the
             write and the load's seconds printed. c. fake replays decoded
             by ``ReplayDecoder`` (the install's binary launched per
             version) in a ``ReplayActor`` into an in-script coordinator,
             then two steps of a flagship ``SLLearner`` on batches of a
             ``RemoteSLDataloader`` (3 attention and 1 scatter launches a
             step). Each kernel's first call captured on both paths against
             its plain version. d. on a thread from the start of phase
             10, the
             entry points as processes on the smoke model:
             ``rl_train --type all --env sc2`` for one iteration (both
             agents on a fake server process through ``DISTAR_SC2_PORT``),
             ``sl_train --type replay_actor`` feeding ``sl_train --remote``
             (2 steps), ``bin/replay_fleet.py`` over the same replays
             through the install's ``ReplayDecoder`` (its report line),
             ``play.py --game_type agent_vs_bot --model1`` a smoke-size
             reference ``.pth``, and ``bin/observe.py --endpoint --frames``
             attached to a live fake game (3 PPM frames). Printed: the
             env's observe + ``transform_obs`` ms, policy flush and teacher
             ms, decisions/s, decoded steps/s, SL step ms and losses, the
             processes' seconds and the script's wait on them.
             ``python3 chip_smoke.py --only sc2`` runs this phase alone.

The line before the last is the ``kernels`` JSON (launches: the serve,
serve-process, fleet (gateway A), SL, SL runtime, RL and distillation
paths, the RL loop's and the replay loop's actor and learner together, the
Anakin windows and learner steps, the league learner's windows and step and
its arena batch, the meshed step and the feeder's run, the SC2 actor's
flushes and the SL steps on decoded replays, each read from zero around its
run); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # CUDA cores: the scatter kernels' additions
PEAK_TF32_FLOPS = 495e12  # tensor cores: the f32 attention's 3xTF32 products
PEAK_BF16_FLOPS = 989e12  # tensor cores: the bf16 attention's products
# tensor-core passes of the attention's products: 3xTF32 for f32 inputs; in
# bf16 one for Q K^T and two (P split hi + lo) for P V
ATTN_PASSES = {"float32": 3.0, "bfloat16": 1.5}
ATTN_PEAK = {"float32": PEAK_TF32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}

SLOTS = 32
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # kernel vs plain, max abs
SCATTER_TOL = 1e-5  # the one-hot plain version sums in matmul order
SCATTER_CASES = ("uniform", "padded", "one_cell")
LOGIT_TOL = 1e-3  # kernel-backed vs 'xla' forward, max abs on unmasked logits


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


TIMING = ("device time per call: the summed durations of the call's device activities "
          "(kernels, fills, copies) over {iters} calls after {warmup} warm-up calls, read from "
          "torch.profiler; the host's time per call and the gaps it leaves on the device are "
          "not counted")


def device_activities(prof):
    """{name: (ms, count)} of the device activities (kernels, fills, copies)
    of a finished torch.profiler run, read off its raw events, with the
    names and durations ``prof.events()`` gives them: building that list
    costs seconds of host time for a train step's thousands of activities."""
    import torch

    names, by_name = {}, {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e.end_ns() - e.start_ns()) / 1e6, n + 1)
    return by_name


def device_ms(fn, iters=20, warmup=3):
    """(device ms per call of ``fn``, {activity name: ms per call}), as
    TIMING says. A wrapper call of a scatter kernel takes about as long on the
    host as on the card, so CUDA events around back-to-back calls would time
    the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # now and then a profiler session reports no device activity at all (seen
    # on the H100 after some hundreds of sessions in one process, three in a
    # row once): run it again, and after three such sessions time the calls
    # with CUDA events instead, which also count the gaps the host leaves
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {k: ms / iters for k, (ms, _) in device_activities(prof).items()}
        if per:
            return sum(per.values()), per
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    print(f"device_ms: the profiler saw no device activity in 3 sessions; CUDA events: {ms:.4f} ms a call")
    return ms, {"cuda_events_ms": ms}


def events_ms(fn, iters=20, warmup=3):
    """ms per call of ``fn`` between two CUDA events around ``iters``
    back-to-back calls: the device's busy time and the gaps the host leaves
    it, a cross-check of ``device_ms`` that no activity of the call can
    escape."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, peak=PEAK_F32_FLOPS, passes=1.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations (``passes`` times ``flops``) over ``peak``, the rate of
    the units the kernel runs them on."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = passes * flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- kernels
def attention_inputs(rng, B, H, N, Dh, mask, dtype, device, garbage=False):
    """q, k, v from the seed and the [B, N] numpy mask, on the card; with
    ``garbage`` the masked K/V rows are +-1e4, which must not reach the
    output."""
    import numpy as np
    import torch

    q, k, v = (rng.standard_normal((B, H, N, Dh)).astype("float32") for _ in range(3))
    if garbage:
        keep = mask[:, None, :, None]
        k, v = (np.where(keep, t, 1e4 * np.sign(t)).astype("float32") for t in (k, v))
    return [torch.from_numpy(t).to(device=device, dtype=dtype) for t in (q, k, v)] + [
        torch.from_numpy(mask).to(device)]


def attention_check(K, tag, q, k, v, mask, want=None):
    """The kernel against the plain version (or ``want``) within ATTN_TOL;
    returns the max abs error."""
    import torch

    got = K.masked_attention(q, k, v, mask)
    want = K.masked_attention_plain(q, k, v, mask) if want is None else want
    name = str(q.dtype)[6:]
    check(got.dtype == q.dtype, f"attention {tag}: output dtype {got.dtype}")
    check(torch.isfinite(got.float()).all(), f"attention {tag} {name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(err <= ATTN_TOL[name], f"attention {tag} {name}: max abs err {err}")
    return err


def non_prefix_mask(rng, B, N, tile, pattern):
    """Valid keys only in the last key tile, or only in every other tile
    (from the second), at random density, at least one per sample."""
    import numpy as np

    tiles = np.arange(N) // tile
    where = tiles == tiles[-1] if pattern == "last_tile" else tiles % 2 == 1
    if not where.any():
        where = tiles == 0
    mask = (rng.random((B, N)) < 0.5) & where
    mask[:, np.flatnonzero(where)[-1]] = True
    return mask


def peaked_inputs(rng, B, H, N, Dh, device):
    """bf16 q, k, v, all keys valid, whose softmax rows put their weight on
    keys 0 and 1 (scores about 20 and 20 - d, d = 0.05-0.15 by query; every
    other key about 0) with V rows +c and -c (c = 500-1000 by head dim). The
    output, about c d / 2, is the difference of two large weighted rows:
    rounding the weights to bf16 (2^-9 of each) moves it by several of its
    bf16 ulps, weights kept near f32 by less than one."""
    import numpy as np
    import torch

    r = Dh ** 0.5  # undoes the 1/sqrt(Dh) scale
    q = np.zeros((B, H, N, Dh), "float32")
    q[..., 0], q[..., 1] = 1.0, rng.uniform(0.5, 1.5, (B, H, N))
    k = 0.1 * rng.standard_normal((B, H, N, Dh)).astype("float32")
    k[:, :, :2] = 0.0
    k[:, :, :2, 0] = 20 * r
    k[:, :, 1, 1] = -0.1 * r
    v = rng.standard_normal((B, H, N, Dh)).astype("float32")
    c = rng.uniform(500, 1000, (B, H, Dh))
    v[:, :, 0], v[:, :, 1] = c, -c
    return [torch.from_numpy(t).to(device, torch.bfloat16) for t in (q, k, v)] + [
        torch.ones(B, N, dtype=torch.bool, device=device)]


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of |want| (8 significant bits)."""
    import torch

    w = want.float()
    _, e = torch.frexp(w)
    return float(((got.float() - w).abs() / torch.ldexp(torch.ones_like(w), e - 8)).max())


def attention_edges(K, rng, device):
    """Every head dim and key count of the card tests, prefix masks with no,
    one, part and all keys valid; non-prefix masks; 1100 keys or samples;
    masked rows at +-1e4. Returns {dtype name: worst error}."""
    import numpy as np
    import torch

    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        errs = []
        for Dh in (4, 8, 32, 128):
            for N in (1, 63, 64, 65, 512):
                mask = np.arange(N)[None, :] < np.array([0, 1, N // 2, N])[:, None]
                errs.append(attention_check(K, f"{N}x{Dh} prefix", *attention_inputs(
                    rng, 4, 2, N, Dh, mask, dt, device)))
        for N, Dh in ((512, 128), (65, 8)):
            for pattern in ("last_tile", "alternating"):
                mask = non_prefix_mask(rng, 4, N, K.ATTENTION_KEY_TILE, pattern)
                errs.append(attention_check(K, f"{N}x{Dh} {pattern}", *attention_inputs(
                    rng, 4, 2, N, Dh, mask, dt, device)))
        # the plan past one warp's word: > 32 key tiles a sample, 1100 samples
        # to rank; sparse masks, a sample with none valid, one all
        side = np.random.default_rng(7)  # apart from rng: the later draws stay as they were
        for B, H, N, Dh in ((3, 2, 1100, 32), (1100, 1, 40, 8)):
            mask = side.random((B, N)) < 0.05
            mask[0], mask[1] = False, True
            errs.append(attention_check(K, f"{B}x{H}x{N}x{Dh} sparse", *attention_inputs(
                side, B, H, N, Dh, mask, dt, device)))
        B, N = 4, 512
        for pattern in ("prefix", "alternating"):
            mask = (np.arange(N)[None, :] < rng.integers(1, N + 1, (B, 1)) if pattern == "prefix"
                    else non_prefix_mask(rng, B, N, K.ATTENTION_KEY_TILE, pattern))
            seed = int(rng.integers(1 << 30))
            clean = attention_inputs(np.random.default_rng(seed), B, 2, N, 128, mask, dt, device)
            dirty = attention_inputs(np.random.default_rng(seed), B, 2, N, 128, mask, dt, device,
                                     garbage=True)
            errs.append(attention_check(K, f"{pattern} masked rows at +-1e4", *dirty,
                                        want=K.masked_attention_plain(*clean)))
        worst[str(dt)[6:]] = max(errs)
        print(f"kernel masked_attention edges {str(dt)[6:]}: {len(errs)} cases (Dh 4/8/32/128 x N "
              f"1/63/64/65/512 prefix, non-prefix, 1100 keys or samples, masked rows at +-1e4), "
              f"worst max_abs_err {max(errs):.3e} (tol {ATTN_TOL[str(dt)[6:]]:.0e})")
    # bf16 weights kept near f32 (P split hi + lo): one output ulp at most
    q, k, v, mask = peaked_inputs(np.random.default_rng(11), 4, 2, 64, 32, device)
    ulps = bf16_ulps(K.masked_attention(q, k, v, mask), K.masked_attention_plain(q, k, v, mask))
    check(ulps <= 1, f"attention bf16 peaked rows: {ulps:.2f} bf16 ulps from the plain version")
    print(f"kernel masked_attention bf16 peaked rows 4x2x64x32: {ulps:.2f} bf16 ulps of |want| "
          f"at most from the plain version (tol 1)")
    return worst


def attention_timing(K, q, k, v, mask):
    """Device ms per call of the kernel, the plain version and SDPA (an
    additive -1e9 mask in the inputs' dtype) on the same inputs; the bound
    restated for the kernel's tensor-core route and the old f32 CUDA-core
    one."""
    import torch
    import torch.nn.functional as Fn

    B, H, N, Dh = q.shape
    name = str(q.dtype)[6:]
    # the keys the function needs: a sample's valid keys, or all N when it has
    # none (its rows are then mean(V)); q read, out written, the K and V rows
    # of those keys read, the mask read
    valid = mask.sum(1)
    keys = int(torch.where(valid > 0, valid, N).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * H * Dh * q.element_size() * keys + mask.numel()
    flops = 4 * H * Dh * N * keys  # every query row against those keys
    add_mask = torch.zeros(B, 1, 1, N, device=q.device, dtype=q.dtype).masked_fill(
        ~mask[:, None, None, :], -1e9)
    ms, per = device_ms(lambda: K.masked_attention(q, k, v, mask))  # the plan, then the attention
    rec = {"ms": ms,
           "plain_ms": device_ms(lambda: K.masked_attention_plain(q, k, v, mask), iters=5)[0],
           "library_ms": device_ms(
               lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=add_mask))[0]}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, ATTN_PEAK[name], ATTN_PASSES[name])
    cuda_core_ms, _ = bound(nbytes, flops)
    print(f"kernel masked_attention {B}x{H}x{N}x{Dh} {name}: ms {rec['ms']:.4f} plain_ms "
          f"{rec['plain_ms']:.4f} library_ms {rec['library_ms']:.4f} (SDPA, {name}); bound_ms "
          f"{rec['bound_ms']:.4f} ({rec['bound_by']}: {nbytes / 1e6:.1f} MB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s, {ATTN_PASSES[name]} passes x {flops / 1e9:.3f} GFLOP "
          f"at {ATTN_PEAK[name] / 1e12:.0f} TFLOP/s) = {rec['bound_ms'] / rec['ms']:.1%} of the "
          f"kernel's time; the f32 CUDA-core bound {cuda_core_ms:.4f} ms; {keys} keys read of "
          f"{B * N}; by activity "
          + json.dumps({act[:60]: round(t, 5) for act, t in per.items()}))
    check(0 < rec["bound_ms"] <= rec["ms"], f"attention {name}: bound {rec['bound_ms']} ms over the "
          f"kernel's {rec['ms']} ms: the count is wrong")
    return rec


def scatter_case(K, rng, case, B, N, D, hw, device):
    """Both scatter kernels on one index case, held bit for bit (signs of
    zeros included) against the entity-order loop ``scatter_add_plain`` and
    each other, and the one-hot kernel within SCATTER_TOL of its matmul-order
    plain version. Returns ((emb, idx), loop err, one-hot err).

    uniform: random cells, 8 rows forced into one cell, two out-of-range
    indices; padded: as observations arrive, ``entity_num`` per sample in
    1..N and the rows past it at cell 0 with embeddings ``-0.0 * x``;
    one_cell: every row of a sample at one cell."""
    import torch

    from distar_tpu_torch.ops import scatter_connection

    emb = rng.standard_normal((B, N, D)).astype("float32")
    idx = rng.integers(0, hw, (B, N))
    if case == "uniform":
        idx[:, :8] = idx[:, :1]  # forced collisions
        idx[:, 8] = -3  # out of range: clipped to 0
        idx[:, 9] = hw + 7  # out of range: clipped to hw-1
    elif case == "padded":
        for b, n in enumerate(rng.integers(1, N + 1, B)):
            idx[b, n:] = 0
            emb[b, n:] *= -0.0
    else:
        idx[:] = rng.integers(0, hw, (B, 1))
    emb, idx = torch.from_numpy(emb).to(device), torch.from_numpy(idx).to(device)
    loop = K.scatter_add_connection(emb, idx, hw)
    onehot = K.scatter_add_onehot(emb, idx, hw)
    plain = K.scatter_add_plain(emb, idx, hw)
    tag = f"scatter {case} {B}x{N}x{D} hw={hw}"
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    check(torch.equal(bits(loop), bits(onehot)), f"{tag}: the two kernels differ")
    check(torch.equal(bits(loop), bits(plain)), f"{tag}: the kernels differ from scatter_add_plain")
    # bf16 rows: the loop kernel adds in bf16 like the Pallas loop kernel,
    # bit-equal to the loop on the bf16 rows; the 'pallas_onehot' route sums
    # in f32 and rounds once. Through scatter_connection on a 1 x hw map,
    # where (x, y) = (idx, 0) is the clipped cell.
    e16, bits16 = emb.bfloat16(), (lambda t: t.view(torch.int16))  # noqa: E731
    loop16 = bits16(K.scatter_add_plain(e16, idx, hw))
    check(torch.equal(bits16(K.scatter_add_connection(e16, idx, hw)), loop16),
          f"{tag} bf16: the loop kernel differs from scatter_add_plain in bf16")
    loc = torch.stack([idx, torch.zeros_like(idx)], -1)
    once16 = bits16(K.scatter_add_plain(e16.float(), idx, hw).bfloat16())
    for impl, want in (("pallas", loop16), ("pallas_onehot", once16)):
        got = scatter_connection(e16, loc, (1, hw), impl=impl).reshape(B, hw, D)
        check(torch.equal(bits16(got), want), f"{tag} bf16: scatter_connection impl={impl} differs")
    err_loop = float((loop - plain).abs().max())
    err_onehot = float((onehot - K.scatter_add_onehot_plain(emb, idx, hw)).abs().max())
    # a cell of hundreds of rows (padded, one-cell) rounds in proportion to its sum
    tol = SCATTER_TOL * (1.0 if case == "uniform" else max(1.0, float(plain.abs().max())))
    check(err_onehot <= tol, f"{tag}: one-hot kernel vs its plain version max abs err {err_onehot}")
    print(f"kernel {tag}: both kernels bit-equal to scatter_add_plain and to each other; "
          f"one-hot vs its matmul-order plain version max_abs_err {err_onehot:.3e} (tol {tol:.1e}); "
          f"bf16: the loop kernel bit-equal to the bf16 loop, the one-hot route to the f32 sum "
          f"rounded once")
    return (emb, idx), err_loop, err_onehot


def index_add_call(emb, idx, hw):
    """The library yardstick: one torch.zeros + index_add_ over the map."""
    import torch

    B, _, D = emb.shape
    flat = (idx.clamp(0, hw - 1) + torch.arange(B, device=idx.device)[:, None] * hw).reshape(-1)
    flat_emb = emb.view(-1, D)
    return lambda: torch.zeros(B * hw, D, device=emb.device).index_add_(0, flat, flat_emb)


def phase_kernels(device, rng):
    """Every kernel vs its plain version at the flagship serve shapes and the
    CPU tests' edge cases; returns per-kernel records (errors and times at
    the serve shapes; the scatter records on the uniform case)."""
    import numpy as np
    import torch

    from distar_tpu_torch.ops import kernels as K

    print("timing: " + TIMING.format(iters=20, warmup=3))
    B, H, N, Dh = SLOTS, 2, 512, 128
    lengths = rng.integers(1, N + 1, B)
    lengths[:3] = (1, N // 3, N)  # one valid key, partial, all
    mask = np.arange(N)[None, :] < lengths[:, None]
    records = {}
    edge_errs = attention_edges(K, rng, device)
    flagship = {}
    for dt in (torch.bfloat16, torch.float32):
        args = attention_inputs(rng, B, H, N, Dh, mask, dt, device)
        err = attention_check(K, f"{B}x{H}x{N}x{Dh}", *args)
        print(f"kernel masked_attention {B}x{H}x{N}x{Dh} {str(dt)[6:]}: max_abs_err {err:.3e}")
        flagship[str(dt)[6:]] = (args, err)
    bf16 = attention_timing(K, *flagship["bfloat16"][0])
    print(json.dumps({"masked_attention_bfloat16": dict(
        bf16, max_abs_err=flagship["bfloat16"][1], edge_max_abs_err=edge_errs["bfloat16"])}))
    rec = attention_timing(K, *flagship["float32"][0])
    rec.update(max_abs_err=flagship["float32"][1], replaces="distar_tpu/ops/pallas_kernels.py:62",
               source="distar_tpu_torch/ops/csrc/masked_attention.cu")
    records["masked_attention"] = rec

    # the uniform cases first (the timed record, the case every earlier run
    # timed); then padded and one-cell
    sB, sN, sD, hw = SLOTS, 512, 32, 152 * 160
    names = ("scatter_add_connection", "scatter_add_onehot")
    cases = {}
    for case in SCATTER_CASES:
        scatter_case(K, rng, case, 2, 16, 4, 63, device)  # hw=63: one ragged tile
        cases[case] = scatter_case(K, rng, case, sB, sN, sD, hw, device)
    (emb, idx), e1, e2 = cases["uniform"]
    nbytes = emb.numel() * 4 + idx.numel() * 4 + sB * hw * sD * 4
    b_ms, b_by = bound(nbytes, emb.numel())
    # the library yardstick by activity: its zero fill writes the whole map
    # (sB * hw * sD * 4 bytes, a bound of its own), so a reading without the
    # fill's activity, or under the map's write time, missed it
    fill_bound_ms = sB * hw * sD * 4 / PEAK_BYTES_PER_S * 1e3
    sessions = [device_ms(index_add_call(emb, idx, hw))]
    while sessions[-1][0] < fill_bound_ms and len(sessions) < 3:
        sessions.append(device_ms(index_add_call(emb, idx, hw)))
    lib_ms, lib_per = sessions[-1]
    ev_ms = events_ms(index_add_call(emb, idx, hw))
    print(f"library index_add_ uniform {sB}x{sN}x{sD} hw={hw}: device ms per call by session "
          f"{[round(m, 5) for m, _ in sessions]}, the last by activity "
          + json.dumps({k[:60]: round(v, 5) for k, v in lib_per.items()})
          + f"; CUDA events {ev_ms:.5f} ms a call; the zero fill's bytes alone bound it at {fill_bound_ms:.5f} ms")
    if lib_ms < fill_bound_ms:
        print("library index_add_: every profiler session read under the zero fill's bound (an activity "
              "missed); library_ms is the CUDA events' time")
        lib_ms = ev_ms
    for name, err, plain in zip(names, (e1, e2), (K.scatter_add_plain, K.scatter_add_onehot_plain)):
        line = 156 if name == "scatter_add_connection" else 231
        fn = getattr(K, name)
        ms, per = device_ms(lambda: fn(emb, idx, hw))
        records[name] = {
            "max_abs_err": err, "replaces": f"distar_tpu/ops/pallas_kernels.py:{line}",
            "source": f"distar_tpu_torch/ops/csrc/{name}.cu", "bound_ms": b_ms, "bound_by": b_by,
            "ms": ms, "plain_ms": device_ms(lambda: plain(emb, idx, hw), iters=3, warmup=1)[0],
            "library_ms": lib_ms}
        print(f"kernel {name} uniform: device ms per call by activity "
              + json.dumps({k[:60]: round(v, 5) for k, v in per.items()}))
    for case in SCATTER_CASES[1:]:
        (emb, idx), _, _ = cases[case]
        times = {name: device_ms(lambda: getattr(K, name)(emb, idx, hw))[0] for name in names}
        lib = device_ms(index_add_call(emb, idx, hw))[0]
        print(f"kernel scatter {case} {sB}x{sN}x{sD} hw={hw}: " + ", ".join(
            f"{name} ms {t:.4f} ({t / records[name]['ms']:.2f}x uniform)" for name, t in times.items())
            + f", library_ms {lib:.4f}, bound_ms {b_ms:.4f}")
    return records


# ------------------------------------------------------------------- serve
def build_model(cfg_overrides, seed, state_dict=None):
    from distar_tpu_torch.model import Model, default_model_config, init_params
    from distar_tpu_torch.utils import deep_merge_dicts

    model = Model(deep_merge_dicts(default_model_config(), cfg_overrides))
    if state_dict is None:
        init_params(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model


def check_output(out, F):
    import numpy as np

    for k, shape in F.ACTION_SHAPES.items():
        check(out["action_info"][k].shape == shape, f"action {k} shape {out['action_info'][k].shape}")
        check(out["action_logp"][k].shape == shape, f"logp {k} shape")
        check(np.isfinite(out["action_logp"][k]).all(), f"logp {k} not finite")
    for k, shape in F.LOGIT_SHAPES.items():
        check(out["logit"][k].shape == shape, f"logit {k} shape {out['logit'][k].shape}")
        check(np.isfinite(out["logit"][k]).all(), f"logit {k} not finite")
    check(0 <= int(out["action_info"]["delay"]) <= F.MAX_DELAY, "delay out of range")


def serve_run(device, cfg_overrides, state_dict, obs):
    """8 sessions x 3 steps + one reset through the port's gateway; returns
    (launch counts of this run, the model's state_dict)."""
    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.serve import BatchedInferenceEngine, InferenceGateway

    model = build_model(cfg_overrides, 0, state_dict)
    infer = BatchedInference(model, num_slots=SLOTS, seed=0, device=device)
    engine = BatchedInferenceEngine(infer)
    gw = InferenceGateway(engine, max_delay_s=0.05).start()
    try:
        gw.load_version("v0", params=model.state_dict(), activate=True)
        engine.warmup(obs[0][0])  # first launches, builds and allocator warm-up
        K.reset_launch_counts()
        sessions = [f"s{i}" for i in range(len(obs))]
        for step in range(3):
            outs = gw.act_many([{"session_id": s, "obs": obs[i][step]} for i, s in enumerate(sessions)])
            for o in outs:
                check(isinstance(o, dict), f"step {step}: {o!r}")
                check(o["session_step"] == step + 1, f"session_step {o['session_step']} at step {step}")
                check_output(o, F)
        check(gw.reset_session(sessions[0]), "reset_session failed")
        check(gw.act(sessions[0], obs[0][0])["session_step"] == 1, "reset did not restart the session")
        counts = dict(K.launch_counts)
        flushes = gw.flushes
    finally:
        gw.drain_and_stop()
    layers = model.cfg["encoder"]["entity"]["layer_num"]
    check(counts["masked_attention"] == layers * flushes,
          f"attention launches {counts['masked_attention']} for {flushes} flushes")
    impl = cfg_overrides["encoder"]["scatter"]["impl"]
    name = "scatter_add_onehot" if impl == "pallas_onehot" else "scatter_add_connection"
    check(counts[name] == flushes, f"{name} launches {counts[name]} for {flushes} flushes")
    print(f"serve scatter.impl={cfg_overrides['encoder']['scatter']['impl']}: {flushes} flushes, "
          f"launches {counts}")
    return counts, model.state_dict()


def phase_serve(device, rng):
    import numpy as np
    import torch

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.model import gumbel_noise

    obs = [[F.random_step_data(rng) for _ in range(3)] for _ in range(8)]
    launches = {}
    state = None
    for impl in ("pallas", "pallas_onehot"):
        counts, state = serve_run(device, overlay(impl, "pallas"), state, obs)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # each kernel-backed forward against the 'xla' strings, same weights/noise
    prepared = [F.random_step_data(rng) for _ in range(SLOTS)]
    outs, infers = {}, {}
    for impl, attn in (("pallas", "pallas"), ("pallas_onehot", "pallas"), ("xla", "xla")):
        infer = BatchedInference(build_model(overlay(impl, attn), 0, state), SLOTS, device=device)
        noise = gumbel_noise(infer.model.cfg, SLOTS, torch.Generator(device=device).manual_seed(7), device)
        outs[impl] = infer.sample(prepared, noise=noise)
        infers[impl] = infer
    for impl in ("pallas", "pallas_onehot"):
        worst = 0.0
        for a, b in zip(outs[impl], outs["xla"]):
            for k in F.ACTION_HEADS:
                check(np.array_equal(a["action_info"][k], b["action_info"][k]),
                      f"{impl}: action {k} differs from the 'xla' forward")
                la, lb = a["logit"][k], b["logit"][k]
                live = la > -1e8
                check(np.array_equal(live, lb > -1e8), f"{impl}: logit {k} masks differ")
                worst = max(worst, float(np.abs(la[live] - lb[live]).max(initial=0.0)))
        check(worst <= LOGIT_TOL, f"{impl} vs 'xla' logits: max abs err {worst}")
        print(f"serve parity scatter.impl={impl} vs xla: actions equal, logits max_abs_err {worst:.3e}")

    # host clock around whole flushes (each ends in the device->host copy),
    # the three forwards in turns, reversing the order each round
    times = {impl: [] for impl in infers}
    order = list(infers)
    for _ in range(8):
        for impl in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infers[impl].sample(prepared)
            times[impl].append((time.perf_counter() - t0) * 1e3)
        order.reverse()
    flush_ms = {impl: statistics.median(t[2:]) for impl, t in times.items()}
    print(f"serve flush ms (median of 6, {SLOTS} slots, host copy included): {flush_ms}")
    profiles = {impl: profile_call(lambda: infer.sample(prepared)) for impl, infer in infers.items()}
    print(json.dumps({"flush_profile": profiles}))
    return launches, flush_ms


def profile_call(fn):
    """One call of ``fn`` (a flush or a train step, ending in a device->host
    copy) under torch.profiler, after one call unprofiled: wall ms,
    device-busy ms (the sum of device activity on the one stream), idle
    share, the number of device activities (kernels and copies) and those
    that take the most time.

    The calls themselves run unguarded, so a kernel fault fails the run;
    only the profiler's own start, stop and event reading may fail softly,
    and then the profile reports why it was not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])  # the device's activities are all it reads
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 - the profiler's own setup
        return {"not_measured": f"profiler start: {e!r}"}
    t0 = time.perf_counter()
    fn()
    wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    try:
        prof.stop()
        by_name = device_activities(prof)
    except Exception as e:  # noqa: BLE001 - the profiler's own teardown and event reading
        return {"not_measured": f"profiler events: {e!r}"}
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "device_activities": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:80], "ms": ms, "count": n} for k, (ms, n) in rows[:10]]}


# ---------------------------------------------------------- serve process
SERVE_LAYERS = 3  # default_model_config's entity transformer layers
SERVE_SESSIONS, SERVE_STEPS = 8, 3
WIRE_ROUNDS = 5  # 8 until the health drill came


def lz4_block(data: bytes) -> bytes:
    """A greedy LZ4-block compressor in plain Python (4-byte hash table, the
    format's end rules: the last 5 bytes literals, no match starting in the
    last 12): the plain encoder the native codec's decoder
    (``comm/native/shuttle.cpp``) is held against. Its streams differ from
    the native encoder's, which matches greedily over a hash table of
    other width, and must decode all the same."""
    import struct

    out = bytearray()

    def length(v):
        while v >= 255:
            out.append(255)
            v -= 255
        out.append(v)

    def emit(lit, offset=None, mlen=0):
        ml = mlen - 4
        out.append((min(len(lit), 15) << 4) | (min(ml, 15) if offset else 0))
        if len(lit) >= 15:
            length(len(lit) - 15)
        out.extend(lit)
        if offset:
            out.extend(struct.pack("<H", offset))
            if ml >= 15:
                length(ml - 15)

    n, table, anchor, i = len(data), {}, 0, 0
    while i < n - 12:
        key = data[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is None or i - j > 0xFFFF:
            i += 1
            continue
        m, end = 4, n - 5
        while i + m + 64 <= end and data[j + m:j + m + 64] == data[i + m:i + m + 64]:
            m += 64
        while i + m < end and data[j + m] == data[i + m]:
            m += 1
        emit(data[anchor:i], i - j, m)
        i = anchor = i + m
    emit(data[anchor:])
    return bytes(out)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def learner_checkpoint(model):
    """A learner checkpoint of ``model``, as the JAX learners write them:
    ``{"params": flax params, "opt_state": optax's adam chain state}`` (the
    moments zero, the count 0)."""
    import numpy as np

    from distar_tpu_torch.model.convert import params_to_flax

    params = params_to_flax(model)

    def zeros(tree):
        return {k: zeros(v) for k, v in tree.items()} if isinstance(tree, dict) else np.zeros_like(tree)

    return {"params": params, "opt_state": ((), (np.int32(0), zeros(params), zeros(params)), ())}


def checkpoint_files(tmp, model, model_v2):
    """v1 and v2 written by the port's ``save_checkpoint``, v1 verified and
    a byte-flipped and a truncated copy of it refused. Returns (v1 path, v2
    path, readings)."""
    from distar_tpu_torch.utils import checkpoint as C

    v1, v2 = os.path.join(tmp, "v1.ckpt"), os.path.join(tmp, "v2.ckpt")
    t0 = time.perf_counter()
    C.save_checkpoint(v1, learner_checkpoint(model), metadata={"iter": 1, "player": "MP0"})
    write_s = time.perf_counter() - t0
    C.save_checkpoint(v2, learner_checkpoint(model_v2), metadata={"iter": 2, "player": "MP0"})
    check(C.verify_checkpoint(v1) and C.verify_checkpoint(v2), "checkpoint: verify_checkpoint failed")
    t0 = time.perf_counter()
    loaded = C.load_checkpoint(v1)
    read_s = time.perf_counter() - t0
    check(loaded["metadata"] == {"iter": 1, "player": "MP0"}, f"checkpoint metadata {loaded['metadata']}")
    blob = open(v1, "rb").read()
    refused = {}
    for name, bad in (("flipped", blob[:len(blob) // 2] + bytes([blob[len(blob) // 2] ^ 0x40])
                       + blob[len(blob) // 2 + 1:]), ("truncated", blob[:-1000])):
        path = os.path.join(tmp, f"v1_{name}.ckpt")
        with open(path, "wb") as f:
            f.write(bad)
        with open(path + ".manifest", "wb") as f:
            f.write(open(v1 + ".manifest", "rb").read())
        check(not C.verify_checkpoint(path), f"checkpoint: the {name} copy verifies")
        try:
            C.load_checkpoint(path)
        except C.CheckpointCorruptError as e:
            refused[name] = str(e)[:90]
        else:
            raise SmokeFailure(f"checkpoint: the {name} copy loaded")
        os.unlink(path)
    return v1, v2, {"bytes": len(blob), "write_s": write_s, "read_s": read_s, "refused": refused}


def stop_all(stack):
    """Stop the frontends and gateways of ``stack``, last started first,
    and empty it."""
    while stack:
        part = stack.pop()
        if hasattr(part, "drain_and_stop"):
            part.drain_and_stop()
        else:
            part.stop()


def same_outputs(got, want, what):
    """Served outputs bit-equal to the in-process gateway's: every action,
    logit and log-prob, and the version and step fields."""
    import numpy as np

    for g, w in zip(got, want):
        check(isinstance(g, dict) and isinstance(w, dict), f"{what}: an error {g!r} / {w!r}")
        for key in ("model_version", "session_step"):
            check(g[key] == w[key], f"{what}: {key} {g[key]} vs {w[key]}")
        for part in ("action_info", "action_logp", "logit") + (("teacher_logit",) if "teacher_logit" in w
                                                              else ()):
            check(part in g, f"{what}: no {part} in the served output")
            for k, v in w[part].items():
                check(np.array_equal(g[part][k], v), f"{what}: {part}[{k}] differs from the in-process "
                      f"gateway's (max abs {np.abs(np.asarray(g[part][k], float) - v).max()})")


def serve_script(act_many, set_teacher, act, obs, teacher, sids=None):
    """The served request script, run on the served stack and on the
    in-process gateway alike: SERVE_SESSIONS sessions (``sids``, by default
    s0, s1, ...) x SERVE_STEPS steps, one ``act_many`` a step; the
    ``teacher`` weights installed after the first step and asked for by the
    even sessions from then on; one more ``act`` for the first session
    (over HTTP on the served stack). Returns every output, in order."""
    sids = sids or [f"s{i}" for i in range(SERVE_SESSIONS)]
    outs = []
    for step in range(SERVE_STEPS):
        if step == 1:
            set_teacher(teacher)
        outs.append(act_many([{"session_id": sids[i], "obs": obs[i][step],
                               **({"want_teacher": True} if step and i % 2 == 0 else {})}
                              for i in range(SERVE_SESSIONS)]))
    outs.append([act(sids[0], obs[0][SERVE_STEPS])])
    return outs


def serve_boot_s(proc, port, t0, log_path):
    """The seconds from ``t0`` until the ``bin/serve.py`` process ``proc``
    answers a ping on ``port``."""
    from distar_tpu_torch.serve import ServeClient

    while True:
        check(proc.poll() is None and time.perf_counter() - t0 < 300,
              f"bin/serve.py did not answer: {open(log_path).read()[-2000:]}")
        try:
            c = ServeClient("127.0.0.1", port, timeout_s=60.0)
            c.ping()
        except OSError:
            time.sleep(0.5)
            continue
        c.close()
        return time.perf_counter() - t0


def phase_serve_process(device, rng, smi, tmp):
    """The serving process on the card (module docstring, phase 5). The
    checkpoints v1 and v2 stay in ``tmp`` for the fleet phase. Returns the
    launch counts of its served requests and its readings."""
    import signal
    import threading
    import urllib.request

    import numpy as np

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.bin import serve as serve_bin
    from distar_tpu_torch.comm import serializer, shuttle
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.obs import MetricsRegistry, set_registry
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.serve import (BatchedInferenceEngine, InferenceGateway, ServeClient,
                                        ServeHTTPServer, ServeTCPServer)
    from distar_tpu_torch.serve.http_frontend import jsonable

    cfg = overlay("pallas", "pallas")
    model, model_v2 = build_model(cfg, 0), build_model(cfg, 1)
    v1_state = {k: v.cpu() for k, v in model.state_dict().items()}
    v2_state = {k: v.cpu() for k, v in model_v2.state_dict().items()}
    proc, stack = None, []
    try:
        v1, v2, ckpt = checkpoint_files(tmp, model, model_v2)
        del model, model_v2
        obs = [[F.random_step_data(rng) for _ in range(SERVE_STEPS + 1)] for _ in range(SERVE_SESSIONS)]

        # the process, bin/serve.py on free ports: it boots beside the
        # in-process stack below (a thread times its first answer); one act
        # and SIGTERM at the end
        http_port, tcp_port = free_port(), free_port()
        log_path = os.path.join(tmp, "serve.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.bin.serve", "--checkpoint", v1, "--slots", "8",
                 "--host", "127.0.0.1", "--http-port", str(http_port), "--tcp-port", str(tcp_port),
                 "--drain-timeout-s", "20", "--device", device.type, "--config", json.dumps({"model": cfg})],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        booted = Background(lambda: serve_boot_s(proc, tcp_port, t0, log_path)).start()

        # the stack as bin/serve.py builds it, on a registry of its own
        set_registry(MetricsRegistry())
        args = serve_bin.parser().parse_args([
            "--checkpoint", v1, "--slots", str(SLOTS), "--max-delay-ms", "50", "--device", device.type,
            "--config", json.dumps({"model": cfg})])
        gw = serve_bin.build_gateway(args)
        gw.start()
        stack.append(gw)
        http = ServeHTTPServer(gw, port=0).start()
        stack.append(http)
        # this phase's wire is TCP: the fleet phase holds the rings
        tcp = ServeTCPServer(gw, port=0, transport="tcp").start()
        stack.append(tcp)
        client = ServeClient(tcp.host, tcp.port, timeout_s=60.0, transport="tcp")
        status = gw.registry.status()["versions"]["v1"]
        url = f"http://{http.host}:{http.port}"

        def post(route, body):
            req = urllib.request.Request(url + route, json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        http_ms = []

        def served_http(session, o):
            t0 = time.perf_counter()
            resp = post("/serve/act", {"session_id": session, "obs": jsonable(o)})
            http_ms.append((time.perf_counter() - t0) * 1e3)
            check(resp["code"] == 0, f"HTTP act: {resp}")
            return {part: ({k: np.asarray(v) for k, v in val.items()} if isinstance(val, dict) else val)
                    for part, val in resp["info"].items()}

        K.reset_launch_counts()
        served = serve_script(client.act_many, client.set_teacher, served_http, obs, v2_state)
        launches = dict(K.launch_counts)
        flushes, teacher_flushes = gw.flushes, gw.teacher_flushes
        metrics = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
        http_status = post("/serve/status", {})
        want_flushes = SERVE_STEPS + 1  # one flush a step, one for the HTTP act
        want_teacher = SERVE_STEPS - 1  # the steps whose lanes asked for teacher logits
        check((flushes, teacher_flushes) == (want_flushes, want_teacher),
              f"served flushes {flushes} and teacher flushes {teacher_flushes}, want {want_flushes} "
              f"and {want_teacher}")
        want = {"masked_attention": SERVE_LAYERS * (want_flushes + want_teacher),
                "scatter_add_connection": want_flushes + want_teacher, "scatter_add_onehot": 0}
        check(launches == want, f"served launches {launches}, want {want}")
        sent = SERVE_SESSIONS * SERVE_STEPS + 1
        line = f'distar_serve_requests_total{{outcome="ok"}} {sent}'
        check(line in metrics.splitlines(), f"/metrics does not count {sent} ok requests: "
              + " | ".join(ln for ln in metrics.splitlines() if ln.startswith("distar_serve_requests")))
        flush_lines = [ln.split() for ln in metrics.splitlines() if ln.startswith("distar_serve_flush_total{")]
        check(sum(float(v) for _, v in flush_lines) == want_flushes, f"/metrics flushes {flush_lines}")
        check(http_status["code"] == 0 and http_status["info"]["generation"] == 1, f"/serve/status {http_status}")

        # the in-process gateway: the same weights as params, seed, order
        set_registry(MetricsRegistry())
        ref_infer = BatchedInference(build_model(cfg, 0, v1_state), SLOTS, seed=args.seed, device=device)
        ref = InferenceGateway(BatchedInferenceEngine(ref_infer), max_delay_s=0.05).start()
        stack.append(ref)
        ref.load_version("v1", params=v1_state, activate=True)

        want_out = serve_script(ref.act_many, ref.set_teacher, ref.act, obs, v2_state)
        for step, (g, w) in enumerate(zip(served, want_out)):
            same_outputs(g, w, f"served step {step}")
        check(all("teacher_logit" in served[s][i] for s in (1, 2) for i in range(0, SERVE_SESSIONS, 2)),
              "teacher logits missing")
        # teacher logits against teacher_step on an in-process engine (the
        # lanes that did not ask hold other actions here than in the served
        # flush; each lane's logits depend on its own inputs only)
        t_infer = BatchedInference(build_model(cfg, 0, v1_state), SLOTS, seed=args.seed, device=device)
        t_infer.set_teacher_params(v2_state)
        teacher_err = 0.0
        for step in (1, 2):
            active = [i < SERVE_SESSIONS and i % 2 == 0 for i in range(SLOTS)]
            prepared = [obs[i][step] if i < SERVE_SESSIONS else ref._template for i in range(SLOTS)]
            outs = [served[step][i if i < SERVE_SESSIONS else 0] for i in range(SLOTS)]
            t_out = t_infer.teacher_step(prepared, outs, active)
            for i in range(0, SERVE_SESSIONS, 2):
                for k, v in t_out[i].items():
                    got, live = served[step][i]["teacher_logit"][k], v > -1e8
                    check(np.array_equal(got > -1e8, live), f"teacher logit {k} masks differ")
                    teacher_err = max(teacher_err, float(np.abs(got[live] - v[live]).max(initial=0.0)))
        check(teacher_err <= LOGIT_TOL, f"teacher logits vs teacher_step: max abs err {teacher_err}")
        del t_infer
        print(f"serve_process outputs: {len(served) - 1} act_many frames x {SERVE_SESSIONS} sessions and "
              f"one HTTP act bit-equal to the in-process gateway (actions, logits, log-probs, teacher "
              f"logits on {SERVE_SESSIONS // 2} lanes x 2 steps); teacher logits vs teacher_step max abs err "
              f"{teacher_err:.3e} (tol {LOGIT_TOL}); launches {launches} "
              f"= {SERVE_LAYERS} x ({want_flushes} + {want_teacher}) flushes; /metrics ok requests {sent}")

        # hot swap: TCP load of v2, swap; the next flush serves v2 on both
        info = client.load("v2", source=v2)
        gen = client.swap("v2")
        ref.load_version("v2", params=v2_state, activate=True)
        req = [{"session_id": f"s{i}", "obs": obs[i][SERVE_STEPS]} for i in range(SERVE_SESSIONS)]
        after, after_ref = client.act_many(req), ref.act_many(req)
        check(all(o["model_version"] == "v2" for o in after), "hot swap: not serving v2")
        same_outputs(after, after_ref, "after the swap")
        for i in range(SERVE_SESSIONS):
            client.end(f"s{i}")
            ref.end_session(f"s{i}")
        # and no request fails across a swap under traffic
        errors, done = [], threading.Event()

        def traffic():
            c = ServeClient(tcp.host, tcp.port, timeout_s=60.0, transport="tcp")
            while not done.is_set():
                for o in c.act_many([{"session_id": f"t{i}", "obs": obs[i][0]} for i in range(4)]):
                    if not isinstance(o, dict):
                        errors.append(repr(o))
            c.close()

        th = threading.Thread(target=traffic)
        th.start()
        client.load("v3", source=v1)
        client.swap("v3")
        time.sleep(0.5)
        done.set()
        th.join(120)
        check(not errors, f"requests failed across the swap: {errors[:3]}")
        check(client.status()["served_version"] == "v3", "the swap under traffic did not land")
        print(f"serve_process hot swap: TCP load v2 ({info['load_s']:.3f} s load, {info['warmup_s']:.3f} s "
              f"warm-up), swap to generation {gen}: the next flush served v2, bit-equal to the in-process "
              f"gateway; a swap under traffic failed no request")

        # the wire: act_many at 32 lanes, HTTP act, a DTL0 frame's decode
        for i in range(4):
            client.end(f"t{i}")
        lanes = [{"session_id": f"w{i}", "obs": obs[i % SERVE_SESSIONS][0]} for i in range(SLOTS)]
        wire_ms, flush_ms = [], []
        for _ in range(WIRE_ROUNDS):
            t0 = time.perf_counter()
            check(all(isinstance(o, dict) for o in client.act_many(lanes)), "a 32-lane act_many failed")
            wire_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            outputs = ref.act_many(lanes)
            flush_ms.append((time.perf_counter() - t0) * 1e3)
            check(all(isinstance(o, dict) for o in outputs), "an in-process act_many failed")
        # the serialization inside that overhead: the 32-lane request and
        # its answer, each encoded and decoded as the client and server do
        split = {}
        for leg, msg in (("request", {"op": "act_many", "requests": lanes}),
                         ("response", {"code": 0, "results": [{"ok": o} for o in outputs]})):
            enc, dec = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                blob = serializer.dumps(msg)
                enc.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                serializer.loads(blob)
                dec.append((time.perf_counter() - t0) * 1e3)
            split[leg] = {"bytes": len(blob), "encode_ms": statistics.median(enc),
                          "decode_ms": statistics.median(dec)}
        raw = serializer.dumps({"op": "act", "session_id": "s0", "obs": obs[0][0]}, compress=False)[4:]
        frame = serializer.MAGIC_LZ + len(raw).to_bytes(8, "little") + lz4_block(raw)
        check(shuttle.lz_decompress(frame[12:], len(raw)) == raw,
              "the DTL0 frame does not decode to its payload")
        decode = []
        for _ in range(3):
            t0 = time.perf_counter()
            serializer.loads(frame)
            decode.append((time.perf_counter() - t0) * 1e3)
        wire = {"tcp_act_many_32_ms": statistics.median(wire_ms), "in_process_act_many_32_ms":
                statistics.median(flush_ms), "http_act_ms": http_ms[0],
                "dtl0_act_frame": {"bytes": len(frame), "raw_bytes": len(raw),
                                   "decode_ms": statistics.median(decode)}}
        wire["wire_overhead_ms"] = wire["tcp_act_many_32_ms"] - wire["in_process_act_many_32_ms"]
        wire["serialization"] = split
        wire["serialization_ms"] = sum(leg["encode_ms"] + leg["decode_ms"] for leg in split.values())
        print(f"serve_process wire split ({smi}): overhead {wire['wire_overhead_ms']:.2f} ms of which "
              f"serialization {wire['serialization_ms']:.2f} ms {json.dumps(split)}; the rest "
              f"(sockets, loopback, frontend threads) {wire['wire_overhead_ms'] - wire['serialization_ms']:.2f} ms")
        client.close()
        stop_all(stack)

        # the process: one act, SIGTERM
        startup_s = booted.result()
        c = ServeClient("127.0.0.1", tcp_port, timeout_s=60.0)
        boot = c.status()["registry"]["versions"]["v1"]
        out = c.act("p0", obs[0][0])
        check(out["session_step"] == 1 and out["model_version"] == "v1", f"process act: {out.keys()}")
        c.close()
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        exit_s = time.perf_counter() - t1
        check(rc == 0, f"bin/serve.py exited {rc} on SIGTERM: {open(log_path).read()[-2000:]}")
        check(exit_s < 20, f"bin/serve.py took {exit_s:.1f} s to drain")
        proc = None
        result = {"checkpoint": ckpt, "registry": {"load_s": status["load_s"], "warmup_s": status["warmup_s"]},
                  "wire": wire, "process": {"startup_s": startup_s, "load_s": boot["load_s"],
                                            "warmup_s": boot["warmup_s"], "sigterm_exit_s": exit_s},
                  "launches": launches, "checkpoints": (v1, v2)}
        print(f"serve_process ({smi}): checkpoint {ckpt['bytes']} bytes, write {ckpt['write_s']:.3f} s, "
              f"read {ckpt['read_s']:.3f} s, flipped and truncated copies refused; registry load_s "
              f"{status['load_s']:.3f} warmup_s {status['warmup_s']:.3f}; TCP act_many at {SLOTS} lanes "
              f"{wire['tcp_act_many_32_ms']:.2f} ms (median of {WIRE_ROUNDS}) vs in-process "
              f"{wire['in_process_act_many_32_ms']:.2f} ms; HTTP act {wire['http_act_ms']:.2f} ms; DTL0 act "
              f"frame {len(frame)} bytes decoded in {wire['dtl0_act_frame']['decode_ms']:.2f} ms; "
              f"bin/serve.py up in {startup_s:.2f} s (load {boot['load_s']:.3f} s, warm-up "
              f"{boot['warmup_s']:.3f} s), exit 0 {exit_s:.2f} s after SIGTERM")
        print(json.dumps({"serve_process": result}))
        return launches, result
    finally:
        stop_all(stack)
        if proc is not None:
            proc.kill()
            proc.wait()
        set_registry(None)


# ------------------------------------------------------------- serve fleet
FLEET_LEASE_S = 30.0  # the gateways' registration lease
FLEET_REFRESH_S = 2.0  # FleetClient's re-discovery cadence
FLEET_CANARY_PCT = 50.0
FLEET_CANARY_SESSIONS = 8
FLEET_SHIP_S = 1.0  # both gateways' telemetry cadence (gateway_proc's default is 2.0, bin/serve.py's 5.0)


def fleet_health_check(coord_srv, port_a, port_b, addr_a):
    """Check b of phase 6: the coordinator's view of both gateways' shipped
    telemetry and traces; gateway A's ship timings and bytes."""
    from distar_tpu_torch.obs import get_fleet_health

    fh = get_fleet_health()
    srcs = (f"serve:{port_a}", f"serve:{port_b}")

    def traced():
        rows = fh.traces.query(limit=1000)
        return all(any(r["source"] == s for r in rows) for s in srcs)

    wait_for(lambda: set(srcs) <= set(fh.store.sources()) and traced(), 60,
             f"serve_fleet: both gateways' telemetry and traces at the coordinator ({sorted(fh.store.sources())})")
    st, hz, hz_ms = get_json(coord_srv.host, coord_srv.port, "/healthz")
    check(st in (200, 503) and set(srcs) <= set(hz["sources"]) and not any(hz["sources"][s]["stale"] for s in srcs),
          f"serve_fleet: /healthz {st} sources {hz.get('sources')}")
    _, listing, _ = get_json(coord_srv.host, coord_srv.port, "/traces?limit=1000")
    rows = {s: [r for r in listing["traces"] if r["source"] == s] for s in srcs}
    check(all(rows.values()), f"serve_fleet: /traces rows by source {[len(v) for v in rows.values()]}")
    slow = max(rows[srcs[1]], key=lambda r: r["dur_ms"])
    st, body, trace_ms = get_json(coord_srv.host, coord_srv.port, f"/trace/{slow['trace_id']}")
    wf = body.get("waterfall", {})
    check(st == 200 and wf.get("critical_path") and wf.get("segments") and wf.get("total_s", 0) > 0,
          f"serve_fleet: the slow request's waterfall {st} {json.dumps(body)[:2000]}")
    return {"sources": sorted(hz["sources"]), "healthz_status": st, "healthz_ms": hz_ms, "trace_ms": trace_ms,
            "traces": {s: len(v) for s, v in rows.items()}, "slow_trace": {
                "name": slow["name"], "dur_ms": slow["dur_ms"], "spans": len(body["spans"]),
                "span_sources": sorted({sp["source"] for sp in body["spans"]}),
                "critical_path": len(wf["critical_path"]), "top_segment": wf["segments"][0]},
            "ship_gateway": ship_timings(srcs[0], (coord_srv.host, coord_srv.port), endpoint=addr_a),
            "store": {"series": fh.store.stats()["series"], "sources": len(fh.store.sources())}}


def counter_sum(prefix):
    """The sum of the process registry's series whose name starts with
    ``prefix``, over every label set."""
    from distar_tpu_torch.obs import get_registry

    return sum(v for k, v in get_registry().snapshot().items() if k.startswith(prefix))


def split_sessions(ring, addrs):
    """SERVE_SESSIONS session ids that the ring spreads over every gateway
    of ``addrs``, two at least on each and one of the even ones (those that
    ask for the teacher in ``serve_script``) on each, so every gateway
    serves teacher flushes: those of the first prefix that does, so the
    choice depends on the addresses alone."""
    for prefix in "stuvwxyzabcdefgh":
        sids = [f"{prefix}{i}" for i in range(SERVE_SESSIONS)]
        owners = [ring.lookup(s) for s in sids]
        if all(owners.count(a) >= 2 and a in owners[::2] for a in addrs):
            return sids
    raise SmokeFailure(f"no session prefix spreads over {addrs}")


def timed(fn, what):
    """(ms, result) of one call whose every answer must be an output."""
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    check(all(isinstance(o, dict) for o in out), f"{what}: {[o for o in out if not isinstance(o, dict)][:2]}")
    return ms, out


def phase_serve_fleet(device, rng, smi, v1, v2):
    """The serving fleet on the card (module docstring, phase 6). Returns the
    launch counts of gateway A's served requests and the readings."""
    import io
    import pickle
    import signal
    import threading
    import zlib

    import torch

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.bin import serve as serve_bin
    from distar_tpu_torch.comm import serializer, shuttle
    from distar_tpu_torch.comm.coordinator import CoordinatorServer
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.obs import MetricsRegistry, TelemetryShipper, set_registry
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.replay.sharding import HashRing
    from distar_tpu_torch.serve import (BatchedInferenceEngine, InferenceGateway, ServeClient,
                                        ServeHTTPServer, ServeTCPServer)
    from distar_tpu_torch.serve.fleet import (FleetClient, FleetRollout, GatewayMap, fetch_canary,
                                              register_gateway)

    t_phase = time.perf_counter()
    cfg = overlay("pallas", "pallas")
    v1_state = {k: v.cpu() for k, v in build_model(cfg, 0).state_dict().items()}
    v2_state = {k: v.cpu() for k, v in build_model(cfg, 1).state_dict().items()}
    obs = [[F.random_step_data(rng) for _ in range(SERVE_STEPS + 1)] for _ in range(SERVE_SESSIONS)]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    log_b = os.path.join(log_dir, "gateway_b.log")
    set_registry(MetricsRegistry())  # the phase's series, fleet and shm included
    stack, proc, fc, ctl, clients = [], None, None, None, []
    result = {}
    try:
        coord_srv = CoordinatorServer(port=0)
        coord_srv.start()
        stack.append(coord_srv)
        coord = (coord_srv.host, coord_srv.port)
        serve_flags = ["--slots", str(SLOTS), "--max-delay-ms", "50", "--device", device.type,
                       "--config", json.dumps({"model": cfg})]

        # b. gateway B, bin/serve.py as a process on this card, starts while
        # gateway A (the stack bin/serve.py builds, in process) is built.
        # Both hold float32 as float32: the port's device rule turns TF32
        # off (actor.inference.resolve_device)
        t0 = time.perf_counter()
        with open(log_b, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.bin.serve", "--checkpoint", v1, "--host", "127.0.0.1",
                 "--http-port", "0", "--tcp-port", "0", "--drain-timeout-s", "20", "--coordinator-addr",
                 f"{coord_srv.host}:{coord_srv.port}", "--lease-s", str(FLEET_LEASE_S),
                 "--telemetry-interval-s", str(FLEET_SHIP_S), *serve_flags],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        args = serve_bin.parser().parse_args(["--checkpoint", v1, *serve_flags])
        gw_a = serve_bin.build_gateway(args).start()
        stack.append(gw_a)
        http_a = ServeHTTPServer(gw_a, host="127.0.0.1", port=0).start()
        stack.append(http_a)
        tcp_a = ServeTCPServer(gw_a, host="127.0.0.1", port=0).start()
        stack.append(tcp_a)
        addr_a = f"{tcp_a.host}:{tcp_a.port}"
        register_gateway(coord, tcp_a.host, tcp_a.port,
                         meta={"players": [], "slots": SLOTS, "http_port": http_a.port, "version": "v1",
                               "mock": False}, lease_s=FLEET_LEASE_S, target=gw_a)
        # A ships as bin/serve.py's gateway does, to the fleet's coordinator
        shipper_a = TelemetryShipper(f"serve:{tcp_a.port}", coordinator_addr=coord, interval_s=FLEET_SHIP_S,
                                     endpoint=addr_a).start()
        stack.append(shipper_a)
        while True:
            check(proc.poll() is None and time.perf_counter() - t0 < 300,
                  f"gateway B did not register: {open(log_b).read()[-2000:]}")
            gmap = GatewayMap.discover(coord)
            if len(gmap) == 2:
                break
            time.sleep(0.5)
        startup_b = time.perf_counter() - t0
        addr_b = next(a for a in gmap.addrs if a != addr_a)
        check(gmap.meta[addr_b]["slots"] == SLOTS and gmap.meta[addr_a]["http_port"] == http_a.port,
              f"registration meta {gmap.meta}")

        # c. affinity: serve_script through a FleetClient that discovered
        # both; each answer bit-equal to an in-process gateway fed what the
        # ring sent that gateway, in the same order
        fc = FleetClient(coordinator_addr=coord, timeout_s=120.0, refresh_s=FLEET_REFRESH_S)
        ring = HashRing(sorted(gmap.addrs))
        sids = split_sessions(ring, gmap.addrs)
        owner = {s: ring.lookup(s) for s in sids}
        flushes0, teacher0 = gw_a.flushes, gw_a.teacher_flushes
        K.reset_launch_counts()
        served = serve_script(fc.act_many, fc.set_teacher, fc.act, obs, v2_state, sids=sids)
        launches = dict(K.launch_counts)
        flushes, teacher_flushes = gw_a.flushes - flushes0, gw_a.teacher_flushes - teacher0
        check({s: fc.router.gateway_for(s) for s in sids} == owner,
              f"pins {fc.router.stats()['pins_per_gateway']} are not the ring's owners")
        want = {"masked_attention": SERVE_LAYERS * (flushes + teacher_flushes),
                "scatter_add_connection": flushes + teacher_flushes, "scatter_add_onehot": 0}
        want_flushes = SERVE_STEPS + (owner[sids[0]] == addr_a)
        check(launches == want and flushes == want_flushes and teacher_flushes == SERVE_STEPS - 1,
              f"gateway A launches {launches} for {flushes} + {teacher_flushes} flushes, want {want} "
              f"and {want_flushes} + {SERVE_STEPS - 1}")
        for addr in gmap.addrs:
            ref = InferenceGateway(BatchedInferenceEngine(BatchedInference(
                build_model(cfg, 0, v1_state), SLOTS, seed=args.seed, device=device)), max_delay_s=0.05).start()
            ref.load_version("v1", params=v1_state, activate=True)

            def act_many(reqs, ref=ref, addr=addr):
                outs = iter(ref.act_many([r for r in reqs if owner[r["session_id"]] == addr]))
                return [next(outs) if owner[r["session_id"]] == addr else None for r in reqs]

            def act(s, o, ref=ref, addr=addr):
                return ref.act(s, o) if owner[s] == addr else None

            try:
                want_out = serve_script(act_many, ref.set_teacher, act, obs, v2_state, sids=sids)
            finally:
                ref.drain_and_stop()
            del ref
            for step, (g, w) in enumerate(zip(served, want_out)):
                kept = [(gi, wi) for gi, wi in zip(g, w) if wi is not None]
                same_outputs([k[0] for k in kept], [k[1] for k in kept],
                             f"fleet step {step}, gateway {'A' if addr == addr_a else 'B'}")
        torch.cuda.empty_cache()
        on_b = [s for s in sids if owner[s] == addr_b]
        result["affinity"] = {"sessions_on_a": len(sids) - len(on_b), "sessions_on_b": len(on_b),
                              "gateway_b_startup_s": startup_b, "gateway_a_launches": launches}
        print(f"serve_fleet affinity: {len(sids)} sessions x {SERVE_STEPS} act_many steps + 1 act through "
              f"FleetClient, {len(sids) - len(on_b)} on A (in process) and {len(on_b)} on B (bin/serve.py "
              f"process, registered {startup_b:.2f} s after its start), each on its HashRing owner; every "
              f"answer bit-equal to an in-process gateway fed its gateway's sessions in order (teacher logits "
              f"on the even sessions); gateway A launches {launches} = {SERVE_LAYERS} x ({flushes} + "
              f"{teacher_flushes} teacher) flushes")

        # d. rollout: a canary on B, promote, then a rollout whose load NACKs
        ctl = FleetRollout(GatewayMap.discover(coord), timeout_s=300.0, coordinator_addr=coord)
        t0 = time.perf_counter()
        verdict = ctl.canary_start("v2", [addr_b], FLEET_CANARY_PCT, source=v2, router=fc.router)
        canary_s = time.perf_counter() - t0
        check(verdict["ok"], f"canary_start: {verdict}")
        check(fetch_canary(coord) == {"addrs": [addr_b], "pct": FLEET_CANARY_PCT, "version": "v2"},
              f"published canary {fetch_canary(coord)}")
        canary_sids = [f"c{i}" for i in range(FLEET_CANARY_SESSIONS)]
        _, outs = timed(lambda: fc.act_many([{"session_id": c, "obs": obs[i % SERVE_SESSIONS][0]}
                                             for i, c in enumerate(canary_sids)]), "canary sessions")
        to_b = [fc.router.is_canary_session(c) for c in canary_sids]
        check(0 < sum(to_b) < len(canary_sids), f"the canary split put {sum(to_b)} of {len(canary_sids)} on B")
        for c, b, o in zip(canary_sids, to_b, outs):
            check(fc.router.gateway_for(c) == (addr_b if b else addr_a), f"canary session {c} misrouted")
            check(o["model_version"] == ("v2" if b else "v1"), f"canary session {c}: {o['model_version']}")
        _, outs = timed(lambda: fc.act_many([{"session_id": s, "obs": obs[i][0]} for i, s in enumerate(sids)]),
                        "existing sessions under the canary")
        for s, o in zip(sids, outs):
            check(fc.router.gateway_for(s) == owner[s], f"session {s} moved for the canary")
            check(o["model_version"] == ("v2" if owner[s] == addr_b else "v1"), f"session {s}: {o['model_version']}")
        t0 = time.perf_counter()
        verdict = ctl.promote("v2", source=v2, router=fc.router)
        promote_s = time.perf_counter() - t0
        check(verdict["ok"] and fc.router.canary_config() == ([], 0.0) and fetch_canary(coord)["pct"] == 0.0,
              f"promote: {verdict}")
        every = sids + canary_sids
        lanes_every = [{"session_id": s, "obs": obs[i % SERVE_SESSIONS][1]} for i, s in enumerate(every)]
        _, outs = timed(lambda: fc.act_many(lanes_every), "after promote")
        check(all(o["model_version"] == "v2" for o in outs), "promote: not every gateway serves v2")
        nack = ctl.rollout("v3", source=os.path.join(log_dir, "missing.ckpt"))
        current = {a: st.get("registry", {}).get("current") for a, st in ctl.fleet_status().items()}
        check(not nack["ok"] and nack["outcome"] == "load_nack", f"rollout of a missing checkpoint: {nack}")
        check(current == {addr_a: "v2", addr_b: "v2"}, f"after the NACKed rollout: {current}")
        _, outs = timed(lambda: fc.act_many(lanes_every), "after the NACKed rollout")
        check(all(o["model_version"] == "v2" for o in outs), "the NACKed rollout changed a served version")
        result["rollout"] = {"canary_start_s": canary_s, "promote_s": promote_s, "canary_on_b": sum(to_b),
                             "canary_sessions": len(canary_sids), "nack": nack["outcome"]}
        print(f"serve_fleet rollout: canary v2 on B at {FLEET_CANARY_PCT:g}% ({canary_s:.2f} s): "
              f"{sum(to_b)} of {len(canary_sids)} new sessions on B answering v2, the rest on A answering v1, "
              f"existing sessions unmoved; promote ({promote_s:.2f} s): every gateway v2; a rollout of a "
              f"missing checkpoint answered {nack['outcome']} and left {current}")

        # b'. fleet health: both gateways' snapshots and request traces at the
        # coordinator, read before B drains (its lease's end evicts them)
        result["health"] = fleet_health_check(coord_srv, tcp_a.port, int(addr_b.rsplit(":", 1)[1]), addr_a)
        print(f"serve_fleet health ({smi}): both gateways ship every {FLEET_SHIP_S:g} s; the coordinator's "
              f"/healthz lists both, /traces holds request traces of both, a slow request's waterfall has its "
              f"critical path: {json.dumps(result['health'])}")

        # e. drain: SIGTERM B under traffic
        steps = {s: [] for s in every}
        untyped, rounds, stop_traffic = [], [0], threading.Event()
        migrations0 = counter_sum("distar_fleet_session_migrations_total")
        reroutes0 = counter_sum("distar_fleet_reroutes_total")
        on_b = [s for s in every if fc.router.gateway_for(s) == addr_b]

        def traffic():
            while not stop_traffic.is_set():
                for s, o in zip(every, fc.act_many(lanes_every)):
                    if isinstance(o, dict):
                        steps[s].append(o["session_step"])
                    else:
                        untyped.append(repr(o))
                rounds[0] += 1

        th = threading.Thread(target=traffic, name="fleet-traffic")
        th.start()
        try:
            while rounds[0] < 1:
                check(th.is_alive(), "the traffic thread died")
                time.sleep(0.01)
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            while addr_b in GatewayMap.discover(coord):
                check(time.perf_counter() - t0 < FLEET_LEASE_S, "B stayed in discovery for its whole lease")
                time.sleep(0.02)
            left_s = time.perf_counter() - t0
            rc = proc.wait(timeout=120)
            exit_s = time.perf_counter() - t0
            r0 = rounds[0]
            while rounds[0] < r0 + 2 and th.is_alive():
                time.sleep(0.01)
        finally:
            stop_traffic.set()
            th.join(300)
        log_tail = open(log_b).read()[-2000:]
        check(rc == 0 and "drained; bye" in log_tail, f"gateway B exited {rc}: {log_tail}")
        proc = None
        check(left_s < FLEET_REFRESH_S, f"B left discovery {left_s:.2f} s after SIGTERM, past one refresh")
        check(not untyped, f"requests failed untyped in the drain: {untyped[:3]}")
        check(all(fc.router.gateway_for(s) == addr_a for s in every), "a session was left on B")
        migrations = counter_sum("distar_fleet_session_migrations_total") - migrations0
        reroutes = counter_sum("distar_fleet_reroutes_total") - reroutes0
        check(migrations == len(on_b) and reroutes >= len(on_b),
              f"{len(on_b)} sessions on B: {migrations} migrations, {reroutes} reroutes")
        for s in every:
            seq = steps[s]
            drops = [k for k in range(1, len(seq)) if seq[k] != seq[k - 1] + 1]
            if s in on_b:
                check(len(drops) == 1 and seq[drops[0]] == 1, f"migrated session {s} steps {seq}")
            else:
                check(not drops, f"session {s} on A restarted: {seq}")
        result["drain"] = {"left_discovery_s": left_s, "exit_s": exit_s, "sessions_migrated": len(on_b),
                           "migrations": migrations, "reroutes": reroutes, "traffic_rounds": rounds[0]}
        print(f"serve_fleet drain: SIGTERM to B under traffic; B left discovery after {left_s:.3f} s (lease "
              f"{FLEET_LEASE_S:g} s, refresh {FLEET_REFRESH_S:g} s), finished its admitted requests and exited 0 "
              f"{exit_s:.2f} s after the signal; its {len(on_b)} sessions moved to A (migrations {migrations:g}, "
              f"reroutes {reroutes:g}), session_step restarting at 1, in {rounds[0]} rounds no request failed")

        # f. the wire at 32 lanes against A: in process, TCP (DTL0), shm
        for s in every:
            fc.end(s)
        lanes = [{"session_id": f"w{i}", "obs": obs[i % SERVE_SESSIONS][0]} for i in range(SLOTS)]
        _, outputs = timed(lambda: gw_a.act_many(lanes), "a 32-lane act_many in process")
        request = {"op": "act_many", "requests": lanes}
        answer = {"code": 0, "results": [{"ok": o} for o in outputs]}
        raw_bytes = {leg: len(serializer.dumps(msg, compress=False)) for leg, msg in
                     (("request", request), ("response", answer))}
        ring_bytes = -(-(int(1.25 * max(raw_bytes.values())) + (1 << 16)) // 4096) * 4096
        try:
            shm_free = shutil.disk_usage("/dev/shm").free
        except OSError:
            shm_free = None
        print(f"serve_fleet wire: ring_bytes {ring_bytes} (raw request {raw_bytes['request']} and answer "
              f"{raw_bytes['response']} bytes; the default ring is 4 MiB), /dev/shm free {shm_free} bytes")
        check(shm_free is None or shm_free >= 2 * ring_bytes, f"/dev/shm has {shm_free} bytes free, two rings "
              f"need {2 * ring_bytes}")

        # a. the native shuttle on the 32-lane answer
        t0 = time.perf_counter()
        shuttle.build()
        build_s = time.perf_counter() - t0
        raw = pickle.dumps(answer, protocol=5)
        check(shuttle.crc32(raw) == zlib.crc32(raw), "native crc32 differs from zlib.crc32")
        t0 = time.perf_counter()
        stream = shuttle.lz_compress(raw)
        lz_enc = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        check(shuttle.lz_decompress(stream, len(raw)) == raw, "the native LZ4 does not round-trip the answer")
        lz_dec = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        check(shuttle.py_lz_decompress(stream, len(raw)) == raw,
              "the plain decoder reads the native stream otherwise")
        plain_dec = (time.perf_counter() - t0) * 1e3
        act_raw = serializer.dumps({"op": "act", "session_id": "w0", "obs": obs[0][0]}, compress=False)[4:]
        block = lz4_block(act_raw)
        check(shuttle.lz_decompress(block, len(act_raw)) == act_raw,
              "the native decoder reads lz4_block's stream otherwise")
        result["shuttle"] = {"library_build_or_load_s": build_s, "answer_bytes": len(raw),
                             "lz4_bytes": len(stream), "encode_ms": lz_enc, "decode_ms": lz_dec,
                             "plain_decode_ms": plain_dec, "lz4_block_frame_bytes": len(block)}
        print(f"serve_fleet shuttle: crc32 = zlib.crc32; the 32-lane answer ({len(raw)} bytes) LZ4 {len(stream)} "
              f"bytes, native encode {lz_enc:.2f} ms / decode {lz_dec:.2f} ms, round trip exact; the plain "
              f"decoder reads it to the same bytes in {plain_dec:.1f} ms; the native decoder reads lz4_block's "
              f"act frame ({len(block)} of {len(act_raw)} bytes)")

        tcp_client = ServeClient(tcp_a.host, tcp_a.port, timeout_s=120.0, transport="tcp")
        clients.append(tcp_client)
        wire_srv = ServeTCPServer(gw_a, host="127.0.0.1", port=0, ring_bytes=ring_bytes).start()
        stack.append(wire_srv)
        shm_client = ServeClient(wire_srv.host, wire_srv.port, timeout_s=120.0, transport="shm")
        clients.append(shm_client)
        check(shm_client.transport_active == "shm", "the shm client got no rings")
        fallbacks0 = counter_sum("distar_shm_fallbacks_total")
        frames0 = counter_sum("distar_shm_tx_frames_total")
        routes = {"in_process": lambda: gw_a.act_many(lanes), "tcp": lambda: tcp_client.act_many(lanes),
                  "shm": lambda: shm_client.act_many(lanes)}
        ms = {name: [] for name in routes}
        for _ in range(WIRE_ROUNDS):  # the three routes in turns
            for name, fn in routes.items():
                ms[name].append(timed(fn, f"a 32-lane act_many ({name})")[0])
        fallbacks = counter_sum("distar_shm_fallbacks_total") - fallbacks0
        frames = counter_sum("distar_shm_tx_frames_total") - frames0
        # A's status sums its two TCP frontends: tcp_a (the fleet's and the
        # TCP row's connections) and wire_srv (the shm row's alone)
        transports = gw_a.status()["transports"]
        on_wire, on_tcp_a = wire_srv.transport_counts(), tcp_a.transport_counts()
        check(fallbacks == 0 and shm_client.transport_active == "shm",
              f"the shm row fell back to TCP ({fallbacks:g} fallbacks): not a ring measurement")
        check(on_wire == {"tcp": 0, "shm": 1} and on_tcp_a["tcp"] >= 1
              and transports == {k: on_wire[k] + on_tcp_a[k] for k in on_wire} and frames == 2 * WIRE_ROUNDS,
              f"status transports {transports} (ring server {on_wire}, A's server {on_tcp_a}), {frames:g} ring "
              f"frames for {WIRE_ROUNDS} rounds")
        split = {}
        for leg, msg in (("request", request), ("response", answer)):
            enc, dec, enc_raw, dec_raw = [], [], [], []
            for _ in range(3):
                t0 = time.perf_counter()
                blob = serializer.dumps(msg)
                enc.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                serializer.loads(blob)
                dec.append((time.perf_counter() - t0) * 1e3)
                buf = io.BytesIO()
                t0 = time.perf_counter()
                serializer.dump_stream(msg, buf)
                enc_raw.append((time.perf_counter() - t0) * 1e3)
                view = buf.getbuffer()
                t0 = time.perf_counter()
                serializer.loads(view)
                dec_raw.append((time.perf_counter() - t0) * 1e3)
                view.release()
            split[leg] = {"dtl0_bytes": len(blob), "dtl0_encode_ms": statistics.median(enc),
                          "dtl0_decode_ms": statistics.median(dec), "raw_bytes": raw_bytes[leg],
                          "raw_stream_ms": statistics.median(enc_raw), "raw_decode_ms": statistics.median(dec_raw)}
        wire = {name: statistics.median(v) for name, v in ms.items()}
        wire.update({"tcp_overhead_ms": wire["tcp"] - wire["in_process"],
                     "shm_overhead_ms": wire["shm"] - wire["in_process"], "ring_bytes": ring_bytes,
                     "dev_shm_free_bytes": shm_free, "shm_fallbacks": fallbacks, "transports": transports,
                     "ring_server_transports": on_wire, "serialization": split, "rounds": WIRE_ROUNDS})
        result["wire"] = wire
        print(f"serve_fleet wire ({smi}): 32-lane act_many, median of {WIRE_ROUNDS} in turns: in process "
              f"{wire['in_process']:.2f} ms, TCP (DTL0) {wire['tcp']:.2f} ms (+{wire['tcp_overhead_ms']:.2f}), shm "
              f"{wire['shm']:.2f} ms (+{wire['shm_overhead_ms']:.2f}) over {frames:g} ring frames, 0 fallbacks, "
              f"status transports {transports}; serialization {json.dumps(split)}")
        result["seconds"] = time.perf_counter() - t_phase
        print(f"serve_fleet: {result['seconds']:.1f} s")
        print(json.dumps({"serve_fleet": result}))
        return launches, result
    finally:
        for c in clients:
            c.close()
        if fc is not None:
            fc.close()
        if ctl is not None:
            ctl.close()
        stop_all(stack)
        if proc is not None:
            proc.kill()
            proc.wait()
        shutil.rmtree(log_dir, ignore_errors=True)
        set_registry(None)


def serve_phases(device, smi, tmp):
    """Phases 5 and 6 (the serving process, then the serving fleet on its
    checkpoints) in a process of their own (``Spawned``) beside the rl
    phase's first parts, which time nothing; each on a generator of its
    own, as in the script's order. Returns each phase's launch counts and
    readings and the seconds of each."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    process = phase_serve_process(device, np.random.default_rng(5), smi, tmp)
    t1 = time.perf_counter()
    fleet = phase_serve_fleet(device, np.random.default_rng(6), smi, *process[1]["checkpoints"])
    return {"serve_process": process, "serve_fleet": fleet,
            "phase_s": {"serve_process": round(t1 - t0, 1), "serve_fleet": round(time.perf_counter() - t1, 1)}}


# ------------------------------------------------------------------- train
TRAIN_B, TRAIN_T = 2, 32  # SL_LEARNER_DEFAULTS: 64 frames a step
TRAIN_ITERS = 8
# one f32 step under each config string, max |a - b| / max(|b|, 1) over loss,
# info and grad_norm. The strings differ only inside the kernels: the scatter
# kernels are bit-equal to the loop and the attention within 1e-5 of its
# plain version (3xTF32), so the loss moves by about 1e-6 of itself; the
# argmax metrics are equal unless a near-tie flips. 1e-4 leaves two decades.
STEP_TOL = 1e-4

RL_B, RL_T = 4, 16  # RL_LEARNER_DEFAULTS: 64 acted frames, 68 observed a step
RL_BIG_B, RL_BIG_T = 6, 64  # the reference's trajectories x steps on one GPU (BASELINE.md)
RL_ITERS = 8
# the RL and distillation strings' whole gradients: within GRAD_TOL of the
# 'xla' gradient's norm, and every held wiring fault (``rl_faults``) further
# from it than that (``hold_strings``). The sound strings part by the
# reference model's own kinks, not by a fault of the port (``rl_gap``): of
# about 4e8 ReLU and max-pool decisions in an RL step, 40-260 sit within
# f32 rounding (inputs 1e-8 to 1e-5 against a row scale of 0.1-6) and fall
# on either side in any two f32 runs, and one that carries a large gradient
# moves the whole gradient (UPGO's test never flipped). On an H100, f32
# 'xla' itself lies 2.0e-3 from an f64 yardstick on one batch while
# 'pallas' lies 2.9e-5 from it. With every decision pinned to the f64
# run's, or in a smooth copy (GELU, average pool), the strings lie 5e-6 to
# 8e-6 apart on random batches; on zero observations pinning takes 3.1e-3
# to 6.4e-5, the rest being rounding that the LSTM amplifies there (f32
# 'xla' alone 3.8e-5 from f64). So the sound gap is set by which kinks a
# batch puts near zero: 9.1e-5 to 2.2e-3 on random batches, 3.1e-3 on zero
# observations. Dropping UPGO moves the gradient 2.4e-2 to 5.5e-2, crossing
# the time and batch axes 0.9 to 1.2. 1e-2 lies between.
GRAD_TOL = 1e-2
# the dynamics tree's scalars that derive from the gradient (its norms, the
# update's, the clip's fraction) part between the strings as the gradient
# does: held at GRAD_TOL, relative, as grad_norm is in ``steps_agree``
GRAD_KEYS = ("dyn/grad_norm/", "dyn/update_ratio/", "dyn/clip_fraction")
# check d: the tree's norms against an f64 recomputation on the card
TREE_TOL = 1e-5
# the RL gap readings (``rl_gap``): the first intermediate whose max |a - b| /
# max |b| exceeds this names the layer where two strings part
GAP_TOL = 1e-5
# the smooth copy's UPGO step, sigmoid(margin / T): the winloss values are
# 0.01-1, so f32 rounding of a margin (1e-7) moves a lambda by 1e-6
UPGO_SMOOTH_T = 0.1
DISTILL_ITERS = 4
STRINGS = {"pallas": ("pallas", "pallas"), "pallas_onehot": ("pallas_onehot", "pallas"),
           "xla": ("xla", "xla")}


def overlay(scatter_impl, attn_impl, dtype="float32"):
    return {"encoder": {"entity": {"attention_impl": attn_impl}, "scatter": {"impl": scatter_impl}},
            "dtype": dtype}


# fewer layers at the flagship's widths, for processes that check plumbing
# (roles as processes, SIGTERM exits, restarts) and quote no flagship figure
SHALLOW_LAYERS = 1  # entity transformer layers: one attention launch a forward


def shallow(scatter_impl, attn_impl):
    """``overlay`` on the flagship cut to one layer of every stack: the
    entity transformer, the spatial encoder's and heads' residual blocks,
    the core LSTM and the value towers."""
    cfg = overlay(scatter_impl, attn_impl)
    cfg["encoder"]["entity"]["layer_num"] = SHALLOW_LAYERS
    cfg["encoder"]["spatial"] = {"resblock_num": 1}
    cfg["encoder"]["core_lstm"] = {"num_layers": 1}
    cfg["policy"] = {"action_type_head": {"res_num": 1}, "location_head": {"res_num": 1}}
    cfg["value"] = {"res_num": 1}
    return cfg


def rel_err(got, want):
    """max |got - want| / max(|want|, 1): absolute below 1, relative above
    (a bf16 gradient of 8 has an ulp of 0.0625)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def train_kernel_grads(K, rng, device, entity_num, Dh=128, D=32):
    """Each kernel's autograd Function at a training shape: attention
    [F, 2, 512, Dh] with the batch's F entity counts, f32 and bf16; both
    scatter kernels on [F, 512, D], hw 24,320, uniform and padded indices
    (F = 64 frames for the SL step, 68 for the RL step; Dh 64 and D 16 are
    the distillation student's).

    The forward is the kernel: its output is held against the plain version
    on the same inputs (attention max abs within ATTN_TOL, both scatters bit
    for bit against the entity-order loop ``scatter_add_plain``). The
    backward is the JAX formula in plain PyTorch and sees the kernel only
    through the saved inputs, so its check holds that formula against
    autograd through the plain version (attention via ``rel_err`` within
    ATTN_TOL; the scatter gather exactly: one dout element a gradient, as
    autograd through the one-hot plain version gives it). Returns the
    inputs for the timings."""
    import numpy as np
    import torch

    B, H, N = len(entity_num), 2, 512
    mask = np.arange(N)[None, :] < entity_num[:, None]
    fwd, bwd, inputs = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, m = attention_inputs(rng, B, H, N, Dh, mask, dt, device)
        w = torch.from_numpy(rng.standard_normal((B, H, N, Dh)).astype("float32")).to(device, dt)
        outs, grads = {}, {}
        for name, fn in (("kernel", K.masked_attention), ("plain", K.masked_attention_plain)):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            outs[name] = fn(*leaves, m)
            (outs[name] * w).sum().backward()
            grads[name] = [t.grad for t in leaves]
        name = str(dt)[6:]
        got = outs["kernel"].detach()
        check(got.dtype == dt and torch.isfinite(got.float()).all(), f"attention {name}: forward output")
        err = float((got.float() - outs["plain"].detach().float()).abs().max())
        check(err <= ATTN_TOL[name], f"attention forward {name}: max abs err {err}")
        fwd[f"masked_attention_{name}"] = err
        err = max(rel_err(a, b) for a, b in zip(grads["kernel"], grads["plain"]))
        check(all(g.dtype == dt for g in grads["kernel"]), f"attention {name}: gradient dtype")
        check(err <= ATTN_TOL[name], f"attention backward formula {name}: err {err}")
        bwd[f"masked_attention_{name}"] = err
        inputs[name] = (q, k, v, m, w)
    hw = 152 * 160
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for case in ("uniform", "padded"):
        emb = rng.standard_normal((B, N, D)).astype("float32")
        idx = rng.integers(0, hw, (B, N))
        if case == "uniform":
            idx[:, :8] = idx[:, :1]
            idx[:, 8], idx[:, 9] = -3, hw + 7  # clipped to the edge cells
        else:
            for b, n in enumerate(entity_num):
                idx[b, n:] = 0
                emb[b, n:] *= -0.0
        emb, idx = torch.from_numpy(emb).to(device), torch.from_numpy(idx).to(device)
        w = torch.from_numpy(rng.standard_normal((B, hw, D)).astype("float32")).to(device)
        loop = K.scatter_add_plain(emb, idx, hw)
        e = emb.clone().requires_grad_()
        (K.scatter_add_onehot_plain(e, idx, hw) * w).sum().backward()
        for name in ("scatter_add_connection", "scatter_add_onehot"):
            got = emb.clone().requires_grad_()
            out = getattr(K, name)(got, idx, hw)
            check(torch.equal(bits(out.detach()), bits(loop)), f"{name} forward {case}: differs from "
                  f"scatter_add_plain")
            fwd[f"{name}_{case}"] = float((out.detach() - loop).abs().max())
            (out * w).sum().backward()
            check(torch.equal(got.grad, e.grad), f"{name} gather backward {case}: differs from "
                  f"autograd through the plain version")
            bwd[f"{name}_{case}"] = float((got.grad - e.grad).abs().max())
        inputs[case] = (emb, idx, w)
    print(f"train kernels at [{B}, {H}, {N}, {Dh}] / [{B}, {N}, {D}] hw {hw}, through their autograd "
          f"Functions: forward (kernel vs plain version, max abs; tol {ATTN_TOL}, scatter bit-equal) "
          + json.dumps(fwd) + "; backward formula vs autograd through the plain version (attention "
          "max |a - b| / max(|b|, 1) over dq, dk, dv; scatter max abs, must be 0) " + json.dumps(bwd))
    return inputs, fwd


def sdpa_calls(q, k, v, m, dout):
    """The library yardsticks of the attention at a training shape: SDPA
    with the same boolean key mask, forward, and forward + backward (the
    gradients of q, k and v for ``dout``)."""
    import torch
    import torch.nn.functional as Fn

    mask4 = m[:, None, None, :]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fwd = lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask4)  # noqa: E731
    both = lambda: torch.autograd.grad(  # noqa: E731
        Fn.scaled_dot_product_attention(*leaves, attn_mask=mask4), leaves, dout)
    return fwd, both


def train_kernel_times(K, inputs, tag="train"):
    """Device ms per call of each kernel's forward and backward at a
    training shape (``device_ms``), beside the library calls of the same
    functions (SDPA with the same boolean mask, forward and forward +
    backward, f32 and bf16; ``zeros + index_add_`` and, for its backward,
    an ``index_select`` gather), with bounds counted as in the kernels
    phase: the forward's as there; the attention backward reads q, dout and
    the needed keys' K and V rows, writes dq, dk and dv in full, and does 5
    products of 2 H Dh N keys operations at the f32 CUDA-core peak (a plain
    PyTorch f32 backward, TF32 off); the scatter backward reads the indices
    and one dout row an entity, and writes the gradient."""
    import torch

    q, k, v, m, dout = inputs["float32"]
    B, H, N, Dh = q.shape
    valid = m.sum(1)
    keys = int(torch.where(valid > 0, valid, N).sum())
    out = {}
    fb = 2 * q.numel() * 4 + 2 * H * Dh * 4 * keys + m.numel()
    fwd_ms, _ = device_ms(lambda: K.masked_attention(q, k, v, m))
    bwd_ms, _ = device_ms(lambda: K.masked_attention_backward(q, k, v, m, dout), iters=5, warmup=1)
    rec = out["masked_attention"] = {
        "fwd_ms": fwd_ms, "fwd_bound_ms": bound(fb, 4 * H * Dh * N * keys, PEAK_TF32_FLOPS, 3.0)[0],
        "plain_fwd_ms": device_ms(lambda: K.masked_attention_plain(q, k, v, m), iters=5, warmup=1)[0],
        "bwd_ms": bwd_ms,
        "bwd_bound_ms": bound(5 * q.numel() * 4 + 2 * H * Dh * 4 * keys + m.numel(),
                              10 * H * Dh * N * keys)[0]}
    for name in ("float32", "bfloat16"):
        q, k, v, m, dout = inputs[name]
        fwd, both = sdpa_calls(q, k, v, m, dout)
        if name == "bfloat16":
            rec["bf16_fwd_ms"] = device_ms(lambda: K.masked_attention(q, k, v, m))[0]
            rec["bf16_bwd_ms"] = device_ms(lambda: K.masked_attention_backward(q, k, v, m, dout),
                                           iters=5, warmup=1)[0]
            # the same counts at 2 bytes an element: the forward's products on
            # the bf16 tensor cores (1.5 passes, as in the kernels phase), the
            # backward's in f32 on the CUDA cores (it upcasts, as the JAX one)
            rec["bf16_fwd_bound_ms"] = bound(2 * q.numel() * 2 + 2 * H * Dh * 2 * keys + m.numel(),
                                             4 * H * Dh * N * keys, PEAK_BF16_FLOPS, 1.5)[0]
            rec["bf16_bwd_bound_ms"] = bound(5 * q.numel() * 2 + 2 * H * Dh * 2 * keys + m.numel(),
                                             10 * H * Dh * N * keys)[0]
        rec[f"library_{name}_fwd_ms"] = device_ms(fwd)[0]
        rec[f"library_{name}_fwd_bwd_ms"] = device_ms(both, iters=5, warmup=1)[0]
    emb, idx, dmap = inputs["uniform"]  # dmap: an output gradient [B, hw, D]
    hw = dmap.shape[1]
    Bs, Ns, D = emb.shape
    flat = (idx.clamp(0, hw - 1) + torch.arange(Bs, device=idx.device)[:, None] * hw).reshape(-1)
    flat_dmap = dmap.reshape(-1, D)
    library = {"library_fwd_ms": device_ms(index_add_call(emb, idx, hw))[0],
               "library_bwd_ms": device_ms(lambda: flat_dmap.index_select(0, flat))[0]}
    for name in ("scatter_add_connection", "scatter_add_onehot"):
        fn = getattr(K, name)
        out[name] = {"fwd_ms": device_ms(lambda: fn(emb, idx, hw))[0],
                     "fwd_bound_ms": bound(emb.numel() * 4 + idx.numel() * 4 + Bs * hw * D * 4,
                                           emb.numel())[0],
                     "bwd_ms": device_ms(lambda: K.scatter_add_backward(idx, dmap, hw))[0],
                     "bwd_bound_ms": bound(idx.numel() * 8 + 2 * emb.numel() * 4, 0)[0], **library}
    print(json.dumps({f"{tag}_kernel_ms": out, "shapes": {
        "attention": [B, H, N, Dh], "valid_keys": keys, "scatter": [Bs, Ns, D], "hw": hw}}))
    return out


def sl_learner(device, impl="pallas", dtype="float32"):
    """The flagship SL learner (SL_LEARNER_DEFAULTS, seeded ``init_params``)
    under config string ``impl``."""
    from distar_tpu_torch.learner import SLLearner

    return SLLearner({"learner": {"batch_size": TRAIN_B, "unroll_len": TRAIN_T},
                      "model": overlay(*STRINGS[impl], dtype)}, device=device)


def finite(log, keys=("total_loss", "grad_norm")):
    import math

    return all(math.isfinite(log[k]) for k in keys)


def train_entry_point(K, batch):
    """``python -m distar_tpu_torch.bin.sl_train --type learner`` at the
    flagship with the kernel overlay, run through the bin's learner function
    on one fixed batch for TRAIN_ITERS steps with the state carried; its
    per-step log lines are read back from its output. The launch counts
    must rise by one attention call a transformer layer and one scatter
    call a step."""
    import contextlib
    import io
    import itertools

    from distar_tpu_torch.bin import sl_train

    overlay = {"model": {"encoder": {"entity": {"attention_impl": "pallas"},
                                     "scatter": {"impl": "pallas"}}},
               "learner": {"log_freq": 1}}
    args = sl_train.parser().parse_args([
        "--type", "learner", "--full-model", "--iters", str(TRAIN_ITERS),
        "--batch-size", str(TRAIN_B), "--traj-len", str(TRAIN_T), "--config", json.dumps(overlay)])
    before = dict(K.launch_counts)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        lrn = sl_train.learner(args, itertools.repeat(batch))
    rose = {k: K.launch_counts[k] - before[k] for k in before}
    logs = [json.loads(ln) for ln in text.getvalue().splitlines() if ln.startswith("{")]
    check(len(logs) == TRAIN_ITERS, f"entry point: {len(logs)} log lines for {TRAIN_ITERS} steps")
    check(all(finite(lg) for lg in logs), "entry point: a non-finite loss or grad_norm")
    losses = [lg["total_loss"] for lg in logs]
    check(losses[-1] < losses[0], f"entry point: loss {losses[0]} -> {losses[-1]} on a fixed batch")
    layers = lrn.model_cfg.encoder.entity.layer_num  # one attention call a layer
    want = {"masked_attention": layers * TRAIN_ITERS, "scatter_add_connection": TRAIN_ITERS,
            "scatter_add_onehot": 0}
    check(rose == want, f"entry point launches {rose}, want {want}")
    print(f"train entry point (bin/sl_train.py learner, flagship, kernel overlay, f32, fixed batch, "
          f"{TRAIN_ITERS} steps): total_loss " + " ".join(f"{x:.3f}" for x in losses)
          + f"; grad_norm {logs[0]['grad_norm']:.2f} -> {logs[-1]['grad_norm']:.2f}; "
          f"launches {rose}; log line keys {sorted(logs[0])}")
    return losses


def phase_train(device, rng):
    """The SL train step on the card (module docstring, phase 7). Returns
    the launch counts of the train path (every launch after the kernel
    gradient and timing calls) and the measurements."""
    import torch

    from distar_tpu_torch.learner import random_sl_batch
    from distar_tpu_torch.ops import kernels as K

    print(f"train: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    batch = random_sl_batch(TRAIN_B, TRAIN_T, rng)  # one fixed batch, 64 frames
    inputs, train_fwd_err = train_kernel_grads(K, rng, device, batch["entity_num"])
    kernel_ms = train_kernel_times(K, inputs)
    del inputs

    K.reset_launch_counts()
    # config strings agree on one step from the same weights, batch and state
    learners = {impl: sl_learner(device, impl) for impl in STRINGS}
    logs = {impl: lrn._train(batch) for impl, lrn in learners.items()}
    worst = strings_agree(logs, "train step")
    print(f"train step parity vs 'xla' (loss, {len(logs['xla'])} info scalars, grad_norm; "
          f"max |a - b| / max(|b|, 1), tol {STEP_TOL}): {worst}; total_loss "
          + json.dumps({k: lg["total_loss"] for k, lg in logs.items()}))

    losses = train_entry_point(K, batch)

    # step time in turns (3 warm-up steps each, the parity step included),
    # a profiled step and the peak memory of one step
    step_ms, times = step_times(learners, batch, rounds=3, warmup=1)  # cut from 5 and 2 for the drill's time
    frames = TRAIN_B * TRAIN_T
    memory = {impl: step_memory(lrn, batch)[0] for impl, lrn in learners.items()}
    profiles = {impl: profile_call(lambda: lrn._train(batch)) for impl, lrn in learners.items()}
    del learners

    # one bf16 step: finite, no parity claim
    lrn16 = sl_learner(device, dtype="bfloat16")
    log16 = lrn16._train(batch)
    check(finite(log16), f"bf16 train step: loss {log16['total_loss']} grad_norm {log16['grad_norm']}")
    print(f"train bf16 step (kernel overlay): total_loss {log16['total_loss']:.4f} "
          f"grad_norm {log16['grad_norm']:.3f}")
    del lrn16
    launches = dict(K.launch_counts)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the train path")
    result = {"step_ms": step_ms, "step_ms_all": times,
              "sl_frames_per_s": {impl: frames / (ms / 1e3) for impl, ms in step_ms.items()},
              "memory": memory, "step_profile": profiles, "train_kernel_ms": kernel_ms,
              "train_kernel_max_abs_err": train_fwd_err,
              "entry_point_losses": losses, "launches": launches}
    print(json.dumps({"train": result}))
    return launches, result


# ------------------------------------------------------------- SL runtime
RT_TRAJ, RT_HELD_OUT, RT_STEPS = 6, 2, 40  # trajectories x steps: 32-step windows cross their ends
RT_ITERS, RT_SAVE_FREQ, RT_EVAL_FREQ = 8, 4, 4  # the bin as a process (12 steps until the diagnostics came)
RT_BATCHES = 8  # resume equivalence: A trains 8, B 4, C restores B and trains 5-8
# two runs from one state on one batch compute the same loss: the forward
# repeats bit for bit on the card; this is the allowance for that loss
RT_REPEAT_FLOOR = 1e-6
# 8 steps of two straight runs from the same weights and batches part by the
# card's backward, which does not repeat bit for bit (8e-8 to 7e-7 of the
# gradient's norm a step, ``rl_gap``), amplified by Adam and by the model's
# kinks (a ReLU or max-pool decision that f32 rounding flips carries its
# gradient along): on an NVIDIA H100 80GB HBM3 at 700 W two straight runs
# lay 0.0019 to 0.0147 of the loss and 0.0049 to 0.0225 of the parameters'
# norm apart, in two clusters after one flipped decision. A run is held
# within twice the envelope of three straight runs or within these bounds,
# whichever is larger: a wrong, shifted or torn batch moves a step's loss
# 15-20% (this dataset's batches alternate between about 300-340 and 390-410)
RT_TRAJECTORY_TOL = {"loss": 0.03, "params": 0.05}
# the flagship's learner checkpoint: params, mu and nu, 12 bytes a parameter
# and the format's overhead
RT_CKPT_BYTES = 346_103_242


def rt_learner(device, save, scatter, **learner):
    """A flagship SL learner (SL_LEARNER_DEFAULTS at 2 x 32) with its
    experiment directory at ``save``, saving only where asked."""
    from distar_tpu_torch.learner import SLLearner

    return SLLearner({"common": {"save_path": save},
                      "learner": {"batch_size": TRAIN_B, "unroll_len": TRAIN_T, "save_freq": 10 ** 9,
                                  "log_freq": 10 ** 9, **learner},
                      "model": overlay(scatter, "pallas")}, device=device)


def write_dataset(root, n, rng):
    """``n`` trajectories of RT_STEPS ``random_sl_batch`` steps written with
    ``ReplayDataset.save``: (dataset, bytes on disk, seconds)."""
    from distar_tpu_torch.learner import random_sl_batch
    from distar_tpu_torch.learner.sl_dataloader import ReplayDataset, batch_steps

    t0 = time.perf_counter()
    nbytes = 0
    for i in range(n):
        path = ReplayDataset.save(root, f"traj_{i:04d}", batch_steps(random_sl_batch(1, RT_STEPS, rng), RT_STEPS))
        nbytes += os.path.getsize(path)
    return ReplayDataset(root), nbytes, time.perf_counter() - t0


def sl_train_process(tmp, name, device, save, data, iters, config, extra=()):
    """``python -m distar_tpu_torch.bin.sl_train --full-model`` on ``data``
    (the model block of ``config`` over the flagship), its output
    (standard error too) in ``<tmp>/<name>.log``."""
    log_path = os.path.join(tmp, f"{name}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distar_tpu_torch.bin.sl_train", "--type", "learner", "--full-model",
             "--device", device.type, "--data", data, "--save-path", save, "--iters", str(iters),
             "--batch-size", str(TRAIN_B), "--traj-len", str(TRAIN_T), "--config", json.dumps(config),
             *extra],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    return proc, log_path


def process_output(log_path):
    """(JSON log lines, EVAL lines, the resume line, the done line's
    launches or None) of a ``bin/sl_train.py`` log."""
    logs, evals, resume, launches = [], [], "", None
    for ln in open(log_path).read().splitlines():
        if ln.startswith("{"):
            logs.append(json.loads(ln))
        elif ln.startswith("EVAL "):
            evals.append(json.loads(ln[5:]))
        elif ln.startswith("sl_train resume: "):
            resume = ln
        elif ln.startswith("sl_train done: "):
            launches = json.loads(ln.split("launches=", 1)[1])
    return logs, evals, resume, launches


def wait_ok(proc, log_path, what, timeout=300):
    rc = proc.wait(timeout=timeout)
    check(rc == 0, f"{what} exited {rc}: {open(log_path).read()[-3000:]}")


def newest_generation(save):
    from distar_tpu_torch.utils.checkpoint import CheckpointManager

    gens = CheckpointManager(os.path.join(save, "checkpoints")).generations()
    return gens[0] if gens else None


def rel_dist(a, b):
    """||a - b|| / ||b|| over lists of arrays, in float64."""
    import numpy as np

    num = sum(float(((x.astype(np.float64) - y) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y.astype(np.float64) ** 2).sum()) for y in b)
    return (num / den) ** 0.5


def params_of(lrn):
    return [p.detach().float().cpu().numpy() for p in lrn.model.parameters()]


def loss_dist(a, b):
    return max(abs(x["total_loss"] - y["total_loss"]) / abs(y["total_loss"]) for x, y in zip(a, b))


def post_admin(admin, route, body=None):
    import urllib.request

    req = urllib.request.Request(f"http://{admin.host}:{admin.port}/learner/{route}",
                                 data=json.dumps(body or {}).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def runtime_processes(tmp, device, smi, root, train_ds, eval_ds, layers):
    """Phase 8's processes: ``bin/sl_train.py`` for 8 steps, then SIGTERM,
    a restart and a torn generation (module docstring). Returns the
    measurements and the first process's launches."""
    import signal

    import numpy as np

    from distar_tpu_torch.utils import checkpoint as C

    out = {}
    # 2. the bin as a process: 8 steps, a checkpoint every 4, EVAL every 4
    save = os.path.join(root, "run")
    cfg = {"model": shallow("pallas_onehot", "pallas"),
           "learner": {"save_freq": RT_SAVE_FREQ, "log_freq": 1}}
    eval_flags = ("--eval-data", eval_ds.root, "--eval-freq", str(RT_EVAL_FREQ), "--eval-batches", "1")
    t0 = time.perf_counter()
    proc, log_path = sl_train_process(tmp, "sl_train_1", device, save, train_ds.root, RT_ITERS, cfg, eval_flags)
    wait_ok(proc, log_path, "bin/sl_train.py")
    run_s = time.perf_counter() - t0
    logs, evals, resume, p_launches = process_output(log_path)
    check(resume.endswith("cold iter 0 skipped 0"), f"first run's resume line: {resume!r}")
    check([lg["iter"] for lg in logs] == list(range(1, RT_ITERS + 1)), f"log lines {[lg['iter'] for lg in logs]}")
    check(all(finite(lg) for lg in logs), "bin/sl_train.py: a non-finite loss or grad_norm")
    check([e["iter"] for e in evals] == list(range(RT_EVAL_FREQ, RT_ITERS + 1, RT_EVAL_FREQ))
          and all(np.isfinite(e["total_loss"]) for e in evals), f"EVAL lines {evals}")
    gens = C.CheckpointManager(os.path.join(save, "checkpoints")).generations()
    steps = [g["step"] for g in gens]
    check(steps == list(range(RT_ITERS, 0, -RT_SAVE_FREQ)), f"pointer generations {steps}")
    check(all(C.verify_checkpoint(g["path"]) for g in gens), "a recorded generation does not verify")
    runs = RT_ITERS + len(evals)  # forward passes: the steps and one held-out batch an EVAL
    want = {"masked_attention": layers * runs, "scatter_add_connection": 0, "scatter_add_onehot": runs}
    check(p_launches == want, f"bin/sl_train.py launches {p_launches}, want {want}")
    out["process"] = {"seconds": run_s, "losses": [lg["total_loss"] for lg in logs], "evals": evals,
                      "generations": steps, "launches": p_launches}
    print(f"sl_runtime process ({smi}, the flagship's widths at depth {layers}): {RT_ITERS} steps in "
          f"{run_s:.1f} s, exit 0, total_loss "
          + " ".join(f"{lg['total_loss']:.2f}" for lg in logs) + f"; EVAL at {[e['iter'] for e in evals]} "
          f"total_loss {[round(e['total_loss'], 3) for e in evals]}; pointer {steps}; launches {p_launches}")

    # 3. SIGTERM after the next periodic checkpoint, restart, then a torn newest generation
    first = RT_ITERS + RT_SAVE_FREQ
    proc, log_path = sl_train_process(tmp, "sl_train_2", device, save, train_ds.root, 10 ** 6, cfg)
    t0 = time.perf_counter()
    while (newest_generation(save) or {}).get("step", 0) < first:
        check(proc.poll() is None and time.perf_counter() - t0 < 300,
              f"no checkpoint at {first}: {open(log_path).read()[-3000:]}")
        time.sleep(0.05)
    t1 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    term_s = time.perf_counter() - t1
    text = open(log_path).read()
    check(rc == 1 and "checkpoint saved" in text, f"SIGTERM exit {rc}: {text[-3000:]}")
    logs, _, resume, _ = process_output(log_path)
    check(resume.endswith(f"iter {RT_ITERS} skipped 0"), f"second run's resume line: {resume!r}")
    crash = newest_generation(save)
    killed_at = crash["step"]
    check(killed_at == logs[-1]["iter"] and killed_at >= first and C.verify_checkpoint(crash["path"]),
          f"crash save {crash} against the last step {logs[-1]['iter']}")
    proc, log_path = sl_train_process(tmp, "sl_train_3", device, save, train_ds.root, killed_at + 2, cfg)
    wait_ok(proc, log_path, "the restarted bin/sl_train.py")
    logs, _, resume, _ = process_output(log_path)
    check(resume == f"sl_train resume: {crash['path']} iter {killed_at} skipped 0", f"restart: {resume!r}")
    check([lg["iter"] for lg in logs] == [killed_at + 1, killed_at + 2], f"restart logs {logs}")
    torn, before = C.CheckpointManager(os.path.join(save, "checkpoints")).generations()[:2]
    with open(torn["path"], "r+b") as f:
        f.truncate(os.path.getsize(torn["path"]) // 2)
    proc, log_path = sl_train_process(tmp, "sl_train_4", device, save, train_ds.root, before["step"] + 1, cfg)
    wait_ok(proc, log_path, "bin/sl_train.py after a torn generation")
    logs, _, resume, _ = process_output(log_path)
    check(resume == f"sl_train resume: {before['path']} iter {before['step']} skipped 1", f"fallback: {resume!r}")
    check([lg["iter"] for lg in logs] == [before["step"] + 1], f"fallback logs {logs}")
    out["crash"] = {"sigterm_at": killed_at, "sigterm_exit_s": term_s, "torn": torn["step"],
                    "fell_back_to": before["step"]}
    print(f"sl_runtime crash ({smi}): SIGTERM after the checkpoint at {first}: saved at {killed_at}, "
          f"exit {rc} after {term_s:.2f} s; restarted at {killed_at} and trained 2 steps; the torn "
          f"generation {torn['step']} skipped (counted), resumed at {before['step']}")
    shutil.rmtree(save, ignore_errors=True)  # 346 MB a generation
    out["launches"] = p_launches
    return out


def phase_sl_runtime(device, rng, smi, tmp):
    """The SL learner runtime on the card (module docstring, phase 8).
    Returns a function that joins the phase's processes and returns the
    launch counts of its paths and the measurements."""
    import itertools
    import threading

    import numpy as np
    import torch

    from distar_tpu_torch.actor.inference import to_device
    from distar_tpu_torch.learner.hooks import LambdaHook
    from distar_tpu_torch.learner.prefetch import DevicePrefetcher, place_on
    from distar_tpu_torch.learner.sl_dataloader import SLDataloader
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.utils import checkpoint as C

    t_phase = time.perf_counter()
    laps = Laps()
    root = os.path.join(tmp, "sl_runtime")
    layers = 3  # default_model_config's entity transformer layers: one attention call each
    out = {}

    # 1. the datasets, and one batch collated on the host
    train_ds, train_bytes, write_s = write_dataset(os.path.join(root, "train"), RT_TRAJ, rng)
    eval_ds, _, _ = write_dataset(os.path.join(root, "held_out"), RT_HELD_OUT, rng)
    loader = SLDataloader(train_ds, TRAIN_B, TRAIN_T, seed=9)
    collate = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = next(loader)
        collate.append((time.perf_counter() - t0) * 1e3)
    batch_bytes = sum(a.nbytes for a in array_leaves(batch))
    copies = {}
    for how, place in (("pinned_side_path", lambda b: place_on(b, device)),
                       ("pageable_to_device", lambda b: to_device(b, device))):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            place(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        copies[how] = statistics.median(times)
    out["dataset"] = {"trajectories": RT_TRAJ, "steps": RT_STEPS, "bytes": train_bytes,
                      "bytes_per_step": train_bytes / (RT_TRAJ * RT_STEPS), "write_s": write_s,
                      "collate_ms": statistics.median(collate), "batch_bytes": batch_bytes,
                      "h2d_ms": copies}
    print(f"sl_runtime dataset ({smi}): {RT_TRAJ} x {RT_STEPS} steps, {train_bytes} bytes "
          f"({train_bytes / (RT_TRAJ * RT_STEPS):.0f} a step) written in {write_s:.2f} s; one "
          f"{TRAIN_B} x {TRAIN_T} batch collates in {statistics.median(collate):.1f} ms, {batch_bytes} "
          f"bytes, host-to-device {copies['pinned_side_path']:.2f} ms pinned, "
          f"{copies['pageable_to_device']:.2f} ms pageable")

    laps("dataset")
    # 2-3. the bin as processes, on a thread of this process's own while it
    # holds the resume equivalence (4), which times nothing, then times
    # prefetch (5) and the saves (6) beside them
    chain = {}

    def processes():
        try:
            chain.update(runtime_processes(tmp, device, smi, root, train_ds, eval_ds, SHALLOW_LAYERS))
        except BaseException as e:  # noqa: BLE001 - raised on this thread after the join
            chain["error"] = e

    worker = threading.Thread(target=processes, name="sl-train-processes", daemon=True)
    worker.start()

    K.reset_launch_counts()
    # 4. resume equivalence under 'pallas' on the dataset's first 8 batches:
    # A and A' straight, B straight with a save after 4, C restores B
    batches = list(itertools.islice(SLDataloader(train_ds, TRAIN_B, TRAIN_T, seed=5), RT_BATCHES))
    half = RT_BATCHES // 2
    check(bool(batches[half]["new_episodes"].all()), "batch 5 does not restart every trajectory")
    runs = {}
    for name in ("A", "A'"):
        lrn = rt_learner(device, os.path.join(root, "a"), "pallas")
        runs[name] = ([lrn._train(b) for b in batches], params_of(lrn))
        del lrn
    b = rt_learner(device, os.path.join(root, "b"), "pallas")
    b_logs = [b._train(bt) for bt in batches[:half]]
    b.last_iter.update(half)
    path = os.path.join(root, "b", "b.ckpt")
    b.save(path, sync=True)
    saved = b.state
    c = rt_learner(device, os.path.join(root, "c"), "pallas")
    c.restore(path)
    restored = c.state
    same = all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(array_leaves(restored), array_leaves(saved)))
    check(same and c.last_iter.val == half and c.optimizer.count == half,
          "the restored state is not bit-equal to the saved one")
    del saved, restored
    runs["B"] = (b_logs + [b._train(bt) for bt in batches[half:]], params_of(b))
    del b
    c_logs = [c._train(bt) for bt in batches[half:]]
    # C's first step and B's fifth start from one state on one batch: the
    # forward repeats, so their losses agree where later steps part by the
    # backward's repeat
    first = abs(c_logs[0]["total_loss"] - runs["B"][0][half]["total_loss"]) / abs(c_logs[0]["total_loss"])
    check(first <= RT_REPEAT_FLOOR, f"C's first step loss {first:.3g} from B's fifth on the same state")
    # the straight runs' envelope: the largest distance between any two of
    # A, A' and B (three runs, so one outlier does not set it alone)
    names = list(runs)
    envelope = {"loss": max(loss_dist(runs[x][0], runs[y][0]) for x in names for y in names if x < y),
                "params": max(rel_dist(runs[x][1], runs[y][1]) for x in names for y in names if x < y)}
    resumed = {"loss": loss_dist(c_logs, runs["A"][0][half:]), "params": rel_dist(params_of(c), runs["A"][1])}
    del c
    for k, v in resumed.items():
        check(v <= max(2 * envelope[k], RT_TRAJECTORY_TOL[k]),
              f"resumed run {k} {v:.3g} from the straight one, the straight runs' envelope {envelope[k]:.3g}")
    resume_launches = dict(K.launch_counts)
    steps_run = 3 * RT_BATCHES + half
    want = {"masked_attention": layers * steps_run, "scatter_add_connection": steps_run, "scatter_add_onehot": 0}
    check(resume_launches == want, f"resume launches {resume_launches}, want {want}")
    spread = {"loss": loss_dist(runs["A'"][0], runs["A"][0]), "params": rel_dist(runs["A'"][1], runs["A"][1])}
    out["resume"] = {"spread": spread, "envelope": envelope, "resumed": resumed, "first_step": first,
                     "losses": {name: [lg["total_loss"] for lg in logs] for name, (logs, _) in runs.items()}
                     | {"C": [lg["total_loss"] for lg in c_logs]}, "launches": resume_launches}
    print(f"sl_runtime resume ({smi}, 'pallas'): C restored B bit-equal (params, mu, nu, count {half}); C's "
          f"first step {first:.3g} from B's fifth; C vs A loss {resumed['loss']:.3g} params "
          f"{resumed['params']:.3g}; A' vs A (the repeat) loss {spread['loss']:.3g} params "
          f"{spread['params']:.3g}, envelope of A, A', B loss {envelope['loss']:.3g} params "
          f"{envelope['params']:.3g}; launches {resume_launches}")
    laps("resume equivalence")

    # 5. prefetch on and off, through run() on the same dataset batches
    # (beside the processes, to keep the script in its time: its timings read with them on the card)
    K.reset_launch_counts()
    pf = {}
    for depth in (2, 0):
        lrn = rt_learner(device, os.path.join(root, f"prefetch{depth}"), "pallas_onehot", prefetch_depth=depth)
        if depth:
            # the placed batches: the host ones, bit for bit, in order
            probe = DevicePrefetcher(SLDataloader(train_ds, TRAIN_B, TRAIN_T, seed=5), lrn._place_batch,
                                     depth=depth, device=device)
            for want_batch, got in zip(batches[:3], probe):
                host = {k: v for k, v in want_batch.items() if k not in ("new_episodes", "traj_lens")}
                check(all(torch.equal(x, y.to(x.device)) for x, y in
                          zip(array_leaves({k: got[k] for k in host}), array_leaves(to_device(host, "cpu"))))
                      and np.array_equal(got["new_episodes"], want_batch["new_episodes"]) and got["_on_device"],
                      "a prefetched batch differs from its host batch")
            probe.close()
        lrn.set_dataloader(SLDataloader(train_ds, TRAIN_B, TRAIN_T, seed=5))
        rec = {"wall": [], "data": [], "train": [], "logs": []}

        def timing(learner, rec=rec):
            now = time.perf_counter()
            rec["wall"].append((now - rec["t"]) * 1e3)
            rec["t"] = now
            rec["data"].append(learner.log_buffer["data_time"] * 1e3)
            rec["train"].append(learner.log_buffer["train_time"] * 1e3)
            rec["logs"].append(learner.last_log)

        lrn.hooks.add(LambdaHook("rt_timing", "after_iter", timing, priority=0))
        rec["t"] = time.perf_counter()
        lrn.run(RT_BATCHES)
        dist = {"loss": loss_dist(rec["logs"], runs["A"][0]), "params": rel_dist(params_of(lrn), runs["A"][1]),
                "first_step": loss_dist(rec["logs"][:1], runs["A"][0][:1])}
        profile = profile_call(lambda: lrn._train(next(lrn._dataloader)))
        pf[depth] = {"step_ms": statistics.median(rec["wall"][3:RT_BATCHES]),
                     "step_ms_mean": statistics.mean(rec["wall"][3:RT_BATCHES]),
                     "data_wait_ms": statistics.median(rec["data"][3:RT_BATCHES]),
                     "train_ms": statistics.median(rec["train"][3:RT_BATCHES]),
                     "step_ms_all": rec["wall"][:RT_BATCHES], "vs_A": dist,
                     "profile": {k: v for k, v in profile.items() if k != "top"}}
        check(dist["first_step"] <= RT_REPEAT_FLOOR, f"prefetch depth {depth}: first loss {dist['first_step']:.3g} "
              "from A's on the same weights and batch")
        for k in ("loss", "params"):
            check(dist[k] <= max(2 * envelope[k], RT_TRAJECTORY_TOL[k]),
                  f"prefetch depth {depth} against A: {k} {dist[k]:.3g}, the straight runs' envelope "
                  f"{envelope[k]:.3g}")
        pf[depth]["losses"] = [lg["total_loss"] for lg in rec["logs"][:RT_BATCHES]]
        if depth == 0:
            rt = lrn  # kept for the save and admin measurements
        else:
            check(isinstance(lrn._dataloader, DevicePrefetcher), "prefetch_depth 2 did not prefetch")
            lrn._dataloader.close()
            del lrn
            shutil.rmtree(os.path.join(root, f"prefetch{depth}"), ignore_errors=True)
    out["prefetch"] = {"depth_2": pf[2], "depth_0": pf[0]}
    print(f"sl_runtime prefetch ({smi}): step ms (median of 5 after 3; mean) depth 2 {pf[2]['step_ms']:.1f}; "
          f"{pf[2]['step_ms_mean']:.1f} (data wait {pf[2]['data_wait_ms']:.1f}, train {pf[2]['train_ms']:.1f}) vs "
          f"depth 0 {pf[0]['step_ms']:.1f}; {pf[0]['step_ms_mean']:.1f} (data wait {pf[0]['data_wait_ms']:.1f}, "
          f"train {pf[0]['train_ms']:.1f}); "
          f"profiled step idle share {pf[2]['profile'].get('idle_share')} vs {pf[0]['profile'].get('idle_share')}; "
          f"against A: depth 2 {pf[2]['vs_A']}, depth 0 {pf[0]['vs_A']}")

    laps("prefetch")
    # 6. the async save, a sync save, a restore, and the admin API during a run
    path = os.path.join(root, "async.ckpt")
    t0 = time.perf_counter()
    rt.save(path)
    blocked_s = time.perf_counter() - t0
    rt._checkpointer.wait()
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    check(abs(nbytes - RT_CKPT_BYTES) < 1e-3 * RT_CKPT_BYTES and C.verify_checkpoint(path),
          f"checkpoint {nbytes} bytes, about {RT_CKPT_BYTES} expected")
    path = os.path.join(root, "sync.ckpt")
    t0 = time.perf_counter()
    rt.save(path, sync=True)
    sync_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    admin = rt.start_admin()
    posted = {}
    start = rt.last_iter.val

    def client():
        while rt.last_iter.val < start + 1:
            time.sleep(0.01)
        posted["status"] = post_admin(admin, "status")
        posted["save"] = post_admin(admin, "save_ckpt")
        posted["profile"] = post_admin(admin, "profile", {"steps": 1})

    th = threading.Thread(target=client, daemon=True)
    th.start()
    rt.run(start + 5)
    th.join(timeout=60)
    admin.stop()
    check(posted.get("status", {}).get("code") == 0 and posted["status"]["info"]["last_iter"] >= start + 1,
          f"admin status {posted.get('status')}")
    check(posted["save"] == {"code": 0, "info": "queued"}, f"admin save {posted['save']}")
    report = posted["profile"].get("info") or {}
    busy = report.get("profiler_device_busy_us") if isinstance(report, dict) else None
    check(posted["profile"]["code"] == 0 and report["captured_steps"] == 1 and report["buckets"]
          and busy and abs(report["total_device_us"] - busy) <= 0.1 * busy,
          f"admin profile {posted['profile']}")
    admin_gens = [g["step"] for g in rt.checkpoint_manager.generations()]
    check(any(start + 1 <= s < start + 5 for s in admin_gens), f"no admin checkpoint in {admin_gens}")
    out["save"] = {"bytes": nbytes, "async_blocked_s": blocked_s, "async_write_s": write_s,
                   "sync_save_s": sync_save_s, "restore_s": restore_s, "admin_generations": admin_gens}
    print(f"sl_runtime save ({smi}): {nbytes} bytes; async save blocks the loop {blocked_s:.3f} s, "
          f"written in {write_s:.2f} s; sync save {sync_save_s:.2f} s; restore {restore_s:.2f} s; admin "
          f"status at iter {posted['status']['info']['last_iter']}, save_ckpt landed at "
          f"{[s for s in admin_gens if start + 1 <= s < start + 5]}, profile answered the ranked buckets "
          f"{json.dumps({b['bucket']: b['share'] for b in report['buckets']})} of "
          f"{report['total_device_us'] / 1e3:.2f} device ms")

    laps("saves and admin")
    # 7. the held-out evaluation
    before = dict(K.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = rt.evaluate(SLDataloader(eval_ds, TRAIN_B, TRAIN_T, seed=2), max_batches=2)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3 / 2
    eval_launches = {k: K.launch_counts[k] - before[k] for k in before}
    check(all(np.isfinite(v) for v in metrics.values()) and "total_loss" in metrics, f"evaluate {metrics}")
    check(eval_launches == {"masked_attention": 2 * layers, "scatter_add_connection": 0, "scatter_add_onehot": 2},
          f"evaluate launches {eval_launches}")
    del rt
    out["evaluate"] = {"ms_per_batch": eval_ms, "total_loss": metrics["total_loss"], "launches": eval_launches}
    print(f"sl_runtime evaluate ({smi}): {eval_ms:.1f} ms a batch, total_loss {metrics['total_loss']:.3f}, "
          f"launches {eval_launches}")
    in_process = dict(K.launch_counts)
    laps("evaluate")
    out["seconds"] = time.perf_counter() - t_phase

    def finish():
        """2-3's processes joined: they run on beside the work after this
        phase that times nothing (the rl phase's gaps). Returns the phase's
        launch counts and measurements."""
        t0 = time.perf_counter()
        worker.join()
        out["processes_wait_s"] = time.perf_counter() - t0
        if "error" in chain:
            raise chain["error"]
        p_launches = chain.pop("launches")
        out.update(chain)
        shutil.rmtree(root, ignore_errors=True)
        launches = {k: resume_launches[k] + in_process[k] + p_launches[k] for k in in_process}
        for name, n in launches.items():
            check(n > 0, f"{name} never launched on the SL runtime path")
        out["launches"], out["laps"] = launches, laps
        print(f"sl_runtime seconds by part: {json.dumps(laps)}; the processes waited on "
              f"{out['processes_wait_s']:.1f} s after the phase")
        print(f"sl_runtime: {out['seconds']:.1f} s, launches (the process {p_launches}, resume "
              f"{resume_launches}, prefetch, admin and evaluate {in_process})")
        print(json.dumps({"sl_runtime": out}))
        return launches, out

    return finish


def array_leaves(tree):
    """The array leaves of a tree of dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in array_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in array_leaves(v)]
    return [tree]


# --------------------------------------------------------------------- RL
def rl_learner(device, impl="pallas", dtype="float32", B=RL_B, T=RL_T, **learner):
    """The flagship RL learner (RL_LEARNER_DEFAULTS, seeded ``init_params``)
    under config string ``impl``."""
    from distar_tpu_torch.learner import RLLearner

    return RLLearner({"learner": {"batch_size": B, "unroll_len": T, **learner},
                      "model": overlay(*STRINGS[impl], dtype)}, device=device)


def distill_learner(device, impl="pallas", **learner):
    """The distillation student (``student_model_config``) under ``impl``."""
    from distar_tpu_torch.learner import DistillLearner

    return DistillLearner({"learner": {"batch_size": RL_B, "unroll_len": RL_T, **learner},
                           "model": overlay(*STRINGS[impl])}, device=device)


def strings_agree(logs, what):
    """Every config string's step scalars within STEP_TOL of the 'xla'
    string's (max |a - b| / max(|b|, 1)), the dynamics tree's
    gradient-derived ones (``GRAD_KEYS``) within GRAD_TOL of it, relative;
    returns the worst key of each."""
    worst = {}
    for impl in ("pallas", "pallas_onehot"):
        check(set(logs[impl]) == set(logs["xla"]), f"{what} {impl}: info keys differ")
        errs = {k: abs(logs[impl][k] - v) / max(abs(v), 1.0) for k, v in logs["xla"].items()
                if not k.startswith(GRAD_KEYS)}
        key = max(errs, key=errs.get)
        check(errs[key] <= STEP_TOL, f"{what} {impl} vs xla: {key} {logs[impl][key]} vs {logs['xla'][key]}")
        worst[impl] = (key, errs[key])
        for k, v in logs["xla"].items():
            if k.startswith(GRAD_KEYS):
                check(abs(logs[impl][k] - v) <= GRAD_TOL * max(abs(v), 1e-30),
                      f"{what} {impl} vs xla: {k} {logs[impl][k]} vs {v} (tol {GRAD_TOL})")
    check(all(finite(lg, [k for k in ("total_loss", "grad_norm") if k in lg]) for lg in logs.values()),
          f"{what}: a non-finite loss or grad_norm")
    return worst


def step_times(learners, batch, rounds=5, warmup=3):
    """Host ms of ``_train`` (it ends in the device->host copy of the
    scalars) to ``synchronize``, the learners in turns, reversing the order
    each round; (median per learner, every time)."""
    import torch

    for _ in range(warmup):
        for lrn in learners.values():
            lrn._train(batch)
    times = {impl: [] for impl in learners}
    order = list(learners)
    for _ in range(rounds):
        for impl in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learners[impl]._train(batch)
            torch.cuda.synchronize()
            times[impl].append((time.perf_counter() - t0) * 1e3)
        order.reverse()
    return {impl: statistics.median(t) for impl, t in times.items()}, times


def step_memory(lrn, batch):
    """({peak GB, the step's working set in GB}, the step's log) of one
    ``_train``."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log = lrn._train(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_gb": peak / 1e9, "step_gb": (peak - held) / 1e9}, log


def entry_point(K, lrn, iters, what):
    """``lrn.run(iters)`` on its own ``FakeRLDataloader``, as the JAX
    package drives its RL and distillation learners: the launch counts set
    to 0 just before the run and read just after, one attention launch a
    transformer layer and one scatter launch a step; the per-step log lines
    read back from its output. Returns (losses, launches)."""
    import contextlib
    import io

    text = io.StringIO()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(text):
        lrn.run(iters)
    launches = dict(K.launch_counts)
    logs = [json.loads(ln) for ln in text.getvalue().splitlines() if ln.startswith("{")]
    check(len(logs) == iters, f"{what}: {len(logs)} log lines for {iters} steps")
    check(all(finite(lg) for lg in logs), f"{what}: a non-finite loss or grad_norm")
    layers = lrn.model_cfg.encoder.entity.layer_num
    want = {"masked_attention": layers * iters, "scatter_add_connection": iters,
            "scatter_add_onehot": 0}
    check(launches == want, f"{what} launches {launches}, want {want}")
    losses = [lg["total_loss"] for lg in logs]
    print(f"{what} (kernel overlay, f32, FakeRLDataloader, {iters} steps): total_loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad_norm {logs[0]['grad_norm']:.3f} -> {logs[-1]['grad_norm']:.3f}; "
          f"launches {launches}")
    return losses, launches


def loss_grads(loss_fn, lrn, batch):
    """(the loss's info as floats, the gradient of each parameter) of
    ``loss_fn(lrn, device batch)``, without an optimizer step."""
    import torch

    from distar_tpu_torch.actor.inference import to_device

    tb = to_device({k: v for k, v in batch.items() if k != "model_last_iter"}, lrn.device)
    total, info = loss_fn(lrn, tb)
    grads = torch.autograd.grad(total, list(lrn.model.parameters()), allow_unused=True,
                                materialize_grads=True)
    return {k: float(v.detach()) for k, v in info.items()}, grads


def crossed(batch):
    """``batch`` with its observations' time and batch axes crossed: row t*B
    + b of the flattened observations holds frame (b, t) read as [B, T+1],
    as a model that flattened them batch-major would see them."""
    import numpy as np

    def cross(x):
        if isinstance(x, dict):
            return {k: cross(v) for k, v in x.items()}
        x = np.asarray(x)
        return np.ascontiguousarray(np.swapaxes(x, 0, 1)).reshape(x.shape)

    obs = ("spatial_info", "entity_info", "scalar_info", "entity_num")
    return {k: cross(v) if k in obs else v for k, v in batch.items()}


def rl_faults(batch):
    """Wiring faults planted without touching the code, each a (loss
    function, batch, held) that the 'xla' learner runs in place of the
    sound one: the UPGO term dropped, the time and batch axes of the
    observations crossed, both held to move the gradient by more than
    GRAD_TOL; and the KL terms dropped, printed only: at weights 0.02 and
    0.1 they move the gradient about as far as the strings' rounding does
    on zero observations, and the info check (``kl/total``) is what catches
    their loss."""
    import dataclasses

    from distar_tpu_torch.learner import rl_loss

    def with_cfg(**change):
        return lambda lrn, tb: rl_loss(lrn.model, dataclasses.replace(lrn.loss_cfg, **change), tb,
                                       RL_B, RL_T)

    sound = with_cfg()
    return {"no upgo": (with_cfg(upgo_weight=0.0), batch, True),
            "crossed layout": (sound, crossed(batch), True),
            "no kl": (with_cfg(kl_weight=0.0, action_type_kl_weight=0.0), batch, False)}


def hold_strings(what, learners, batch, loss_fn, faults=None, hold_gradient=True):
    """The loss and every info scalar of each config string within STEP_TOL
    of the 'xla' string's (``strings_agree``), each kernel string's whole
    gradient within GRAD_TOL of the 'xla' gradient's norm (printed only
    with ``hold_gradient=False``: the caller holds it), and each planted
    fault of ``faults`` marked held moving the 'xla' gradient by more than
    GRAD_TOL, so that the tolerance is shown to catch it. Printed beside
    them, as the scale of what is held: the 'xla' string's distance from its
    own repeat on the same weights and batch, the parameter groups that
    carry the 'pallas' string's distance (share of its square, and the
    group's own |a - b| / |b|), and under each fault the strings' distance
    again."""
    import torch

    def rel(a, b):
        return float(torch.cat([(x - y).reshape(-1) for x, y in zip(a, b)]).norm()
                     / torch.cat([y.reshape(-1) for y in b]).norm())

    res = {impl: loss_grads(loss_fn, lrn, batch) for impl, lrn in learners.items()}
    worst = strings_agree({impl: info for impl, (info, _) in res.items()}, what)
    gx = res["xla"][1]
    dist = {impl: rel(res[impl][1], gx) for impl in ("pallas", "pallas_onehot")}
    repeat = rel(loss_grads(loss_fn, learners["xla"], batch)[1], gx)
    groups = {}  # first three name parts -> [|a - b|^2, |b|^2]
    for (name, _), a, b in zip(learners["xla"].model.named_parameters(), res["pallas"][1], gx):
        g = groups.setdefault(".".join(name.split(".")[:3]), [0.0, 0.0])
        g[0] += float((a - b).pow(2).sum())
        g[1] += float(b.pow(2).sum())
    total = sum(d for d, _ in groups.values()) or 1.0
    carry = {k: [round(d / total, 4), (d / n) ** 0.5 if n else None]
             for k, (d, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:6]}
    planted = {}
    for name, (fn, fb, held) in (faults or {}).items():
        fx = loss_grads(fn, learners["xla"], fb)[1]
        planted[name] = {"held": held, "moves_xla": rel(fx, gx),
                         "pallas_vs_xla": rel(loss_grads(fn, learners["pallas"], fb)[1], fx)}
    print(f"{what}, strings vs 'xla': loss and {len(res['xla'][0]) - 1} info scalars within {STEP_TOL} "
          f"(worst {worst}); gradient |a - b| / |b|: {json.dumps(dist)} (tol {GRAD_TOL}); 'xla' vs "
          f"its repeat {repeat:.3e}; groups carrying 'pallas' vs 'xla' ([share of |a - b|^2, the "
          f"group's |a - b| / |b|]) "
          f"{json.dumps(carry)}; planted faults {json.dumps(planted)}")
    for impl, d in dist.items():
        check(not hold_gradient or d <= GRAD_TOL, f"{what} {impl}: gradient {d:.4g} of its norm from 'xla'")
    for name, p in planted.items():
        check(not p["held"] or p["moves_xla"] > GRAD_TOL, f"{what}: fault '{name}' moves the gradient only "
              f"{p['moves_xla']:.4g}, within GRAD_TOL")
    return {"strings": dist, "xla_repeat": repeat, "carry": carry, "faults": planted}


def grad_dist(a, b):
    """|a - b| / |b| over two whole gradients (lists of tensors), in f64."""
    import torch

    return float(torch.cat([(x.double() - y.double()).reshape(-1) for x, y in zip(a, b)]).norm()
                 / torch.cat([y.double().reshape(-1) for y in b]).norm())


def set_string(model, scatter, attn):
    """Switch a built model's scatter and entity-attention routes in place:
    the same weights under another config string (``overlay`` sets the
    entity encoder's attention only; the build-order transformer stays
    plain)."""
    from distar_tpu_torch.ops.transformer import Attention

    model.encoder.scatter_impl = scatter
    for m in model.encoder.entity_encoder.modules():
        if isinstance(m, Attention):
            m.impl = attn


class OneLearner(dict):
    """One built learner as a learner per config string: looked up under a
    string (or read by ``items()``), it is switched to that string first
    (``set_string``), and with ``fresh`` its parameters and Adam state put
    back as they were built (``learner_restore``). For checks that run the
    strings one after another on the same weights (``hold_strings``, and
    with ``fresh`` ``steps_agree``): one flagship build in place of three."""

    def __init__(self, lrn, fresh=False):
        super().__init__({impl: lrn for impl in STRINGS})
        self._built = learner_snapshot(lrn) if fresh else None

    def __getitem__(self, impl):
        lrn = super().__getitem__(impl)
        if self._built is not None:
            learner_restore(lrn, self._built)
        set_string(lrn.model, *STRINGS[impl])
        return lrn

    def items(self):
        return ((impl, self[impl]) for impl in self)

    def values(self):
        return (self[impl] for impl in self)


def tapped_loss(loss_fn, lrn, batch):
    """``loss_grads`` with the forward's intermediates tapped: each
    transformer layer's attention (the raw attention ``attention_raw_i``,
    before its output Dense, and the layer's attention block output
    ``attention_i``), the entity embeddings, the scatter map, the spatial
    embedding, the LSTM input and output, every head's logits and every
    value, in forward order. Returns (info, parameter gradients, {name:
    forward value}, {name: gradient of the loss at that tensor}, {layer:
    (attention input, mask)})."""
    import torch

    from distar_tpu_torch.actor.inference import to_device

    model = lrn.model
    taps, att_in = {}, {}
    put = taps.__setitem__
    ent = model.encoder.entity_encoder
    hooks = []
    for i in range(ent.layer_num):
        att = getattr(ent, f"TransformerLayer_{i}").Attention_0
        hooks += [att.register_forward_pre_hook(lambda m, a, i=i: att_in.__setitem__(i, a)),
                  att.Dense_1.register_forward_pre_hook(lambda m, a, i=i: put(f"attention_raw_{i}", a[0])),
                  att.register_forward_hook(lambda m, a, o, i=i: put(f"attention_{i}", o))]
    hooks += [ent.register_forward_hook(lambda m, a, o: put("entity_embeddings", o[0])),
              model.encoder.spatial_encoder.register_forward_pre_hook(lambda m, a: put("scatter_map", a[1])),
              model.encoder.spatial_encoder.register_forward_hook(lambda m, a, o: put("spatial_embedding", o[0])),
              model.core_lstm.register_forward_pre_hook(lambda m, a: put("lstm_input", a[0])),
              model.core_lstm.register_forward_hook(lambda m, a, o: put("lstm_output", o[0]))]
    rl_forward = model.rl_forward

    def record(*a, **kw):
        out = rl_forward(*a, **kw)
        for name, t in out["target_logit"].items():
            put(f"logit_{name}", t)
        for name, t in out["value"].items():
            put(f"value_{name}", t)
        return out

    model.rl_forward = record
    try:
        tb = to_device({k: v for k, v in batch.items() if k != "model_last_iter"}, lrn.device)
        total, info = loss_fn(lrn, tb)
        params = list(model.parameters())
        names = list(taps)
        grads = torch.autograd.grad(total, params + [taps[n] for n in names], allow_unused=True,
                                    materialize_grads=True)
    finally:
        del model.rl_forward
        for h in hooks:
            h.remove()
    return ({k: float(v.detach()) for k, v in info.items()}, grads[:len(params)],
            {n: taps[n].detach() for n in names}, dict(zip(names, grads[len(params):])), att_in)


def tensor_gap(a, b):
    """(max |a - b| / max |b|, the largest over rows (the last axis) of max
    |a - b| / max |b| within the row), in f64; entries where ``b`` is a
    -1e9 fill are left out."""
    import torch

    a, b = a.double(), b.double()
    keep = b.abs() < 1e8
    d = torch.where(keep, (a - b).abs(), 0.0)
    m = torch.where(keep, b.abs(), 0.0)
    whole = float(d.max() / m.max().clamp_min(1e-300))
    rows = d.reshape(-1, d.shape[-1]).amax(1) / m.reshape(-1, m.shape[-1]).amax(1).clamp_min(1e-300)
    return whole, float(rows.max())


def first_over(gaps, tol=GAP_TOL):
    """The first tensor, in the order given, whose gap exceeds ``tol``."""
    return next((name for name, (whole, _) in gaps.items() if whole > tol), None)


def plain_forward_formula_backward(q, k, v, mask):
    """Attention whose forward is the plain version (f32, the kernel's
    numerics) and whose backward is the kernel's formula
    (``masked_attention_backward``): the custom backward without the kernel."""
    import torch

    from distar_tpu_torch.ops import kernels as K

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask):
            ctx.save_for_backward(q, k, v, mask)
            return K.masked_attention_plain(q, k, v, mask)

        @staticmethod
        def backward(ctx, dout):
            return (*K.masked_attention_backward(*ctx.saved_tensors, dout.contiguous()), None)

    return Fn.apply(q, k, v, mask)


def kernel_forward_autograd_backward(q, k, v, mask):
    """The kernel's forward values with autograd through the plain
    version's graph as the backward: plain + (kernel - plain), the second
    term detached."""
    import torch

    from distar_tpu_torch.ops import kernels as K

    plain = K.masked_attention_plain(q, k, v, mask, upcast=False)
    with torch.no_grad():
        kern = K._masked_attention(q, k, v, mask)
    return plain + (kern - plain).detach()


@contextlib.contextmanager
def attention_route(fn):
    """Within the block, the 'pallas' attention route calls ``fn`` in place
    of ``kernels.masked_attention``."""
    from distar_tpu_torch.ops import kernels as K

    saved, K.masked_attention = K.masked_attention, fn
    try:
        yield
    finally:
        K.masked_attention = saved


@contextlib.contextmanager
def float64_model():
    """Within the block, every ``Tensor.float()`` gives float64 and new
    tensors default to float64, so a model moved to ``double()`` computes
    its forward, loss and backward in float64 throughout (the port's code
    casts to float32 with ``.float()`` at the heads, the loss and the
    encoders' inputs)."""
    import torch

    to_float, dtype = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda t, *a, **kw: t.double() if not t.is_complex() else to_float(t, *a, **kw)
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = to_float
        torch.set_default_dtype(dtype)


def float64_batch(batch):
    import numpy as np

    if isinstance(batch, dict):
        return {k: float64_batch(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(float64_batch(v) for v in batch)
    x = np.asarray(batch)
    return x.astype(np.float64) if x.dtype == np.float32 else x


def real_activation_attention(K, att_in, model):
    """The kernel against the plain version on the attention inputs that
    the 'xla' forward of the batch gave each transformer layer: max |a - b|
    over max |b| and its largest value per row, for the kernel and the f32
    plain version each against the plain version in f64; beside them the
    largest score over valid keys and the largest sum_d |q_d k_d| / sqrt(Dh)
    (the scale that the kernel's 3xTF32 error follows)."""
    import torch

    ent = model.encoder.entity_encoder
    out = {}
    with torch.no_grad():
        for i, (x, mask) in att_in.items():
            att = getattr(ent, f"TransformerLayer_{i}").Attention_0
            B, N, _ = x.shape
            q, k, v = (t.reshape(B, N, att.head_num, att.head_dim).transpose(1, 2).contiguous()
                       for t in att.Dense_0(x).chunk(3, dim=-1))
            want = K.masked_attention_plain(q.double(), k.double(), v.double(), mask, upcast=False)
            kern = K._masked_attention(q, k, v, mask)
            plain = K.masked_attention_plain(q, k, v, mask, upcast=False)
            valid = mask.bool()[:, None, None, :]
            scale = att.head_dim ** -0.5
            score = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
            abs_sum = torch.einsum("bhqd,bhkd->bhqk", q.abs(), k.abs()) * scale
            out[f"layer_{i}"] = {
                "kernel_vs_f64": tensor_gap(kern, want), "plain_f32_vs_f64": tensor_gap(plain, want),
                "max_score": float(score.masked_fill(~valid, 0).abs().max()),
                "max_abs_qk_sum": float(abs_sum.masked_fill(~valid, 0).max())}
    return out


class Kinks:
    """Every ReLU and 2x2 max-pool decision of the model's forward, and
    every trace-continues test of the RL loss's UPGO returns, for the RL
    gap readings (``rl_gap``). Within the block ``F.relu``, the blocks'
    ReLU, ``F.max_pool2d`` and the loss's ``upgo_returns`` go through this
    object (a model must be built inside the block for its blocks'
    activations to); ``mode``:

    * ``"pass"``: the plain functions;
    * ``"record"``: the plain functions, each call's decisions kept (which
      inputs are > 0; which element each window takes), in call order;
    * ``"compare"``: the plain functions, each call's decisions counted
      against the recorded ones by call site (``sites``: flips, elements)
      with the first few flipped inputs kept (``flipped``);
    * ``"pin"``: each call takes the recorded decisions (x * the recorded
      mask; the recorded window elements): the function without its kinks
      near this point, as the recording run crossed them;
    * ``"smooth"``: ReLU becomes GELU, the max-pool an average pool of the
      same windows and UPGO's step a sigmoid of its margin at temperature
      UPGO_SMOOTH_T: a copy of the model and loss without those kinks.

    The port's code is untouched: this only patches ``torch.nn.functional``,
    the blocks' activation table and the loss module's ``upgo_returns``
    inside the block."""

    def __init__(self, names=None):
        self.mode, self.ref, self.i = "pass", [], 0
        self.sites, self.flipped, self.names = {}, [], names or {}

    def __enter__(self):
        import torch.nn.functional as Fn

        from distar_tpu_torch.losses import rl_loss
        from distar_tpu_torch.ops import blocks

        self.saved = (Fn.relu, Fn.max_pool2d, blocks.ACTIVATIONS["relu"], rl_loss.upgo_returns)
        Fn.relu = blocks.ACTIVATIONS["relu"] = self.relu
        Fn.max_pool2d = self.max_pool2d
        rl_loss.upgo_returns = self.upgo_returns
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as Fn

        from distar_tpu_torch.losses import rl_loss
        from distar_tpu_torch.ops import blocks

        Fn.relu, Fn.max_pool2d, blocks.ACTIVATIONS["relu"], rl_loss.upgo_returns = self.saved

    def start(self, mode):
        self.mode, self.i, self.sites, self.flipped = mode, 0, {}, []
        if mode == "record":
            self.ref = []

    def _site(self, kind):
        frame = sys._getframe(3)  # _site <- _decide <- relu / max_pool2d / upgo_returns <- the caller
        owner = frame.f_locals.get("self")
        name = self.names.get(id(owner)) if owner is not None else None
        return f"{kind} {name if name is not None else frame.f_code.co_name}"

    def _decide(self, kind, x, got):
        """Keep, count or hand back the call's decisions ``got``."""
        if self.mode == "record":
            self.ref.append(got)
        elif self.mode in ("compare", "pin"):
            ref = self.ref[self.i]
            if self.mode == "pin":
                got = ref
            else:
                flips = got != ref
                n = int(flips.sum())
                site = self._site(kind)
                rec = self.sites.setdefault(site, [0, 0])
                rec[0] += n
                rec[1] += flips.numel()
                if n and kind in ("relu", "upgo") and len(self.flipped) < 16:
                    x = x.detach()
                    for pos in flips.nonzero()[:4].tolist():
                        row = x[tuple(pos[:-1])]
                        self.flipped.append({"site": site, "input": float(x[tuple(pos)]),
                                             "row_max_abs": float(row.abs().max())})
        self.i += 1
        return got

    def relu(self, x, inplace=False):
        import torch.nn.functional as Fn

        if self.mode == "smooth":
            return Fn.gelu(x)
        if self.mode == "pass":
            return self.saved[0](x)
        return x * self._decide("relu", x, x > 0).to(x.dtype)

    def max_pool2d(self, x, kernel_size, stride=None, *args, **kw):
        import torch.nn.functional as Fn

        if self.mode == "smooth":
            return Fn.avg_pool2d(x, kernel_size, stride, *args, **kw)
        if self.mode == "pass":
            return self.saved[1](x, kernel_size, stride, *args, **kw)
        y, idx = self.saved[1](x, kernel_size, stride, return_indices=True)
        idx = self._decide("maxpool", x, idx)
        return x.flatten(2).gather(2, idx.flatten(2)).view_as(y)

    def upgo_returns(self, rewards, bootstrap_values):
        """``ops.rl.upgo_returns`` with its test r_{t+1} + V_{t+2} >= V_{t+1}
        as a decision of this object (the flipped inputs are its margins)."""
        import torch

        from distar_tpu_torch.ops import generalized_lambda_returns

        margin = rewards + bootstrap_values[1:] - bootstrap_values[:-1]
        if self.mode == "smooth":
            lambdas = torch.sigmoid(margin / UPGO_SMOOTH_T)
        else:
            lambdas = (rewards + bootstrap_values[1:]) >= bootstrap_values[:-1]
            if self.mode != "pass":
                lambdas = self._decide("upgo", margin, lambdas)
        lambdas = torch.cat([lambdas[1:], torch.ones_like(lambdas[-1:])], dim=0)
        return generalized_lambda_returns(rewards, 1.0, bootstrap_values, lambdas.to(rewards.dtype))


def rl_gap(device, batch, loss_fn, what, held=True):
    """The RL strings' gradient gap (ROADMAP Queue 3 item 1), on the flagship
    with value towers, f32, TF32 off, one fixed batch; each reading on its
    own line:

    a. 'pallas' against its own repeat;
    b. the mixed strings, kernel attention with the 'xla' scatter and plain
       attention with the kernel scatter, against 'xla';
    c. the forward's intermediates of 'pallas' against 'xla' (``tapped_loss``:
       max |a - b| / max |b| and its largest value per row), the first over
       GAP_TOL named; the gradient of the loss at each of them, likewise;
       the kernel against the plain version on the real activations;
       then the kernel's forward with autograd through the plain version as
       its backward, and the plain forward with the kernel's backward
       formula, each against 'xla': the forward's share and the backward's;
    d. an f64 'xla' gradient as the yardstick, and each f32 string's
       distance from it (gradients, intermediates, gradients at them);
    k. the kinks (``Kinks``): every ReLU, max-pool and UPGO decision of each
       f32 string counted against the f64 run's by call site, with the
       inputs at the first flips beside their row's scale; then the strings
       with every decision pinned to the f64 run's, and a smooth copy (ReLU
       as GELU, max-pool as average pool, UPGO's step as a sigmoid), each
       held to put the strings within GAP_TOL.

    ``held=False`` prints k. without holding it to GAP_TOL. The launches of
    these calls are not the main path's: the caller sets the counts to 0
    after it."""
    from distar_tpu_torch.ops import kernels as K

    res = {}
    with Kinks() as kinks:
        lrn = rl_learner(device, "xla")
        lrn64 = rl_learner(device, "xla")
        lrn64.model.double()
        kinks.names = {id(m): n for n, m in lrn.model.named_modules()}
        model = lrn.model
        runs = {}

        def run(name, scatter, attn):
            set_string(model, scatter, attn)
            runs[name] = tapped_loss(loss_fn, lrn, batch)
            return runs[name]

        run("xla", "xla", "xla")
        run("pallas", "pallas", "pallas")
        gx = runs["xla"][1]

        # a. the kernel string against its own repeat
        again = tapped_loss(loss_fn, lrn, batch)
        res["a"] = {"pallas_repeat": grad_dist(again[1], runs["pallas"][1]),
                    "pallas_repeat_forward_equal": all(
                        bool((again[2][n] == t).all()) for n, t in runs["pallas"][2].items())}
        set_string(model, "xla", "xla")
        res["a"]["xla_repeat"] = grad_dist(tapped_loss(loss_fn, lrn, batch)[1], gx)
        print(f"rl gap ({what}) a. 'pallas' vs its repeat (gradient |a - b| / |b|): "
              f"{res['a']['pallas_repeat']:.3e}, forward intermediates bit-equal "
              f"{res['a']['pallas_repeat_forward_equal']}; 'xla' vs its repeat {res['a']['xla_repeat']:.3e}")

        # b. the mixed strings
        run("attn kernel, scatter xla", "xla", "pallas")
        run("attn xla, scatter kernel", "pallas", "xla")
        run("pallas_onehot", "pallas_onehot", "pallas")
        res["b"] = {name: grad_dist(runs[name][1], gx) for name in
                    ("pallas", "pallas_onehot", "attn kernel, scatter xla", "attn xla, scatter kernel")}
        print(f"rl gap ({what}) b. gradient |a - b| / |b| against 'xla': {json.dumps(res['b'])}")

        # c. intermediates, the gradients at them, the kernel on real activations
        fwd = {n: tensor_gap(t, runs["xla"][2][n]) for n, t in runs["pallas"][2].items()}
        bwd = {n: tensor_gap(t, runs["xla"][3][n]) for n, t in runs["pallas"][3].items()}
        real = real_activation_attention(K, runs["xla"][4], model)
        res["c"] = {"forward": fwd, "first_forward_over": first_over(fwd),
                    "grad_at": bwd, "first_grad_over_from_top": first_over(dict(reversed(bwd.items()))),
                    "kernel_on_real_activations": real}
        print(f"rl gap ({what}) c. 'pallas' vs 'xla' forward intermediates [max |a - b| / max |b|, worst row]: "
              f"{json.dumps(fwd)}; first over {GAP_TOL:.0e}: {res['c']['first_forward_over']}")
        print(f"rl gap ({what}) c. 'pallas' vs 'xla' gradient of the loss at each intermediate: {json.dumps(bwd)}; "
              f"first over {GAP_TOL:.0e} from the loss down: {res['c']['first_grad_over_from_top']}")
        print(f"rl gap ({what}) c. the kernel vs the plain version on the 'xla' forward's attention inputs "
              f"(each against the plain version in f64): {json.dumps(real)}")
        set_string(model, "xla", "pallas")
        with attention_route(kernel_forward_autograd_backward):
            split_fwd = tapped_loss(loss_fn, lrn, batch)
        with attention_route(plain_forward_formula_backward):
            split_bwd = tapped_loss(loss_fn, lrn, batch)
        res["c"]["split"] = {"kernel forward, autograd backward": grad_dist(split_fwd[1], gx),
                             "plain forward, formula backward": grad_dist(split_bwd[1], gx)}
        print(f"rl gap ({what}) c. attention split (scatter 'xla'), gradient against 'xla': "
              f"{json.dumps(res['c']['split'])}")
        del split_fwd, split_bwd

        # d. the f64 yardstick, its kink decisions recorded
        kinks.start("record")
        with float64_model():
            ref = tapped_loss(loss_fn, lrn64, float64_batch(batch))
        kinks.start("pass")
        strings = ("xla", "pallas", "attn kernel, scatter xla", "attn xla, scatter kernel")
        res["d"] = {name: {"gradient": grad_dist(runs[name][1], ref[1]),
                           "first_forward_over": first_over(
                               {n: tensor_gap(t, ref[2][n]) for n, t in runs[name][2].items()}),
                           "first_grad_over_from_top": first_over(
                               {n: tensor_gap(t, ref[3][n]) for n, t in reversed(runs[name][3].items())},
                               tol=1e-4)}
                    for name in strings}
        res["d"]["f64_loss_vs_xla"] = abs(ref[0]["total_loss"] - runs["xla"][0]["total_loss"])
        fwd64 = {name: {n: tensor_gap(t, ref[2][n])[0] for n, t in runs[name][2].items()}
                 for name in ("xla", "pallas")}
        bwd64 = {name: {n: tensor_gap(t, ref[3][n])[0] for n, t in runs[name][3].items()}
                 for name in ("xla", "pallas")}
        print(f"rl gap ({what}) d. f64 'xla' yardstick: each f32 string's gradient |a - b| / |b| from it, the first "
              f"forward tensor over {GAP_TOL:.0e} and the first gradient (from the loss down) over 1e-4: "
              + json.dumps(res["d"]))
        print(f"rl gap ({what}) d. forward intermediates vs f64 (max |a - b| / max |b|): {json.dumps(fwd64)}")
        print(f"rl gap ({what}) d. gradient at each intermediate vs f64: {json.dumps(bwd64)}")
        res["d"]["forward_vs_f64"], res["d"]["grad_at_vs_f64"] = fwd64, bwd64
        del runs

        # k. the kinks: census, then pinned to the f64 run's decisions, then smooth
        census, pinned = {}, {}
        for name, (scatter, attn) in (("xla", ("xla", "xla")), ("pallas", ("pallas", "pallas"))):
            set_string(model, scatter, attn)
            kinks.start("compare")
            loss_grads(loss_fn, lrn, batch)
            census[name] = {"flips": {k: v for k, v in kinks.sites.items() if v[0]},
                            "decisions": sum(v[1] for v in kinks.sites.values()),
                            "first_flipped_inputs": kinks.flipped}
            kinks.start("pin")
            pinned[name] = loss_grads(loss_fn, lrn, batch)[1]
        kinks.start("pin")
        with float64_model():
            pinned_ref = loss_grads(loss_fn, lrn64, float64_batch(batch))[1]
        del lrn64
        smooth = {}
        kinks.start("smooth")
        for name, (scatter, attn) in (("xla", ("xla", "xla")), ("pallas", ("pallas", "pallas"))):
            set_string(model, scatter, attn)
            smooth[name] = loss_grads(loss_fn, lrn, batch)[1]
        kinks.start("pass")
    res["k"] = {"census": census,
                "pinned": {"pallas_vs_xla": grad_dist(pinned["pallas"], pinned["xla"]),
                           "xla_vs_f64": grad_dist(pinned["xla"], pinned_ref),
                           "pallas_vs_f64": grad_dist(pinned["pallas"], pinned_ref)},
                "smooth_pallas_vs_xla": grad_dist(smooth["pallas"], smooth["xla"])}
    for name, c in census.items():
        print(f"rl gap ({what}) k. {name}: {sum(v[0] for v in c['flips'].values())} of {c['decisions']} ReLU, "
              f"max-pool and UPGO decisions on the other side from the f64 run's, by site [flips, decisions]: "
              f"{json.dumps(c['flips'])}; the first flipped ReLU and UPGO inputs beside their row's max |x|: "
              f"{json.dumps(c['first_flipped_inputs'])}")
    print(f"rl gap ({what}) k. every decision pinned to the f64 run's, gradient |a - b| / |b|: "
          f"{json.dumps(res['k']['pinned'])}; a smooth copy (ReLU as GELU, max-pool as average pool, UPGO's "
          f"step as a sigmoid), "
          f"'pallas' vs 'xla': "
          f"{res['k']['smooth_pallas_vs_xla']:.3e} ({f'tol {GAP_TOL:.0e} each' if held else 'printed only'})")
    check(not held or res["k"]["smooth_pallas_vs_xla"] <= GAP_TOL,
          f"rl gap ({what}): the smooth copy leaves the strings {res['k']['smooth_pallas_vs_xla']:.3e} apart")
    check(not held or res["k"]["pinned"]["pallas_vs_xla"] <= GAP_TOL,
          f"rl gap ({what}): with the kinks pinned the strings lie {res['k']['pinned']['pallas_vs_xla']:.3e} apart")
    del lrn
    return res


def steps_agree(what, learners, batch):
    """One ``_train`` step per config string: the loss and every info scalar
    within STEP_TOL of the 'xla' string's, and each grad_norm within
    GRAD_TOL of it (the bound that ``hold_strings`` puts on the whole
    gradient). Returns the logs."""
    logs = {impl: lrn._train(batch) for impl, lrn in learners.items()}
    norms = {impl: lg.pop("grad_norm") for impl, lg in logs.items()}
    worst = strings_agree(logs, what)
    for impl in ("pallas", "pallas_onehot"):
        check(abs(norms[impl] - norms["xla"]) <= GRAD_TOL * norms["xla"],
              f"{what} {impl}: grad_norm {norms[impl]} vs {norms['xla']}")
    for impl, lg in logs.items():
        lg["grad_norm"] = norms[impl]
    print(f"{what} parity vs 'xla' (loss and {len(logs['xla']) - 2} info scalars, max |a - b| / "
          f"max(|b|, 1), tol {STEP_TOL}): {worst}; grad_norm {norms} (tol {GRAD_TOL} of 'xla'); "
          f"total_loss " + json.dumps({k: lg["total_loss"] for k, lg in logs.items()}))
    return logs


def gated_step(device, batch):
    """One step with ``value_pretrain_iters=1``: only ``td/total``'s
    gradient flows, so Adam (b1 = 0) leaves every policy-head parameter bit
    for bit as it was, while the winloss tower moves."""
    import torch

    lrn = rl_learner(device, value_pretrain_iters=1)
    before = {n: p.detach().clone() for n, p in lrn.model.named_parameters()}
    log = lrn._train(batch)
    check(finite(log), "gated step: a non-finite loss or grad_norm")
    moved = {n for n, p in lrn.model.named_parameters() if not torch.equal(p, before[n])}
    policy = [n for n in before if n.startswith("policy.")]
    check(not moved & set(policy), f"gated step moved policy parameters {sorted(moved & set(policy))[:4]}")
    check("value_winloss.Dense_0.weight" in moved, "gated step: the winloss tower did not move")
    groups = sorted({n.split(".")[0] for n in moved})
    print(f"rl gated step (value_pretrain_iters=1): {len(policy)} policy-head parameters bit-equal, "
          f"moved {groups}; td/total {log['td/total']:.4f} total_loss {log['total_loss']:.4f}")
    return groups


# ---------------------------------------------------- learner diagnostics
class Laps(dict):
    """``laps(name)``: the seconds since the previous lap (or since it was
    made) under ``name``: a phase's seconds by part."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        self[name] = round(self.get(name, 0.0) + now - self._t, 1)
        self._t = now


def step_batch(lrn, batch):
    """``batch`` as ``RLLearner._train`` hands it to its step: the host keys
    dropped, float64 leaves as float32, on the learner's device."""
    from distar_tpu_torch.actor.inference import to_device
    from distar_tpu_torch.learner.data import as_float32

    data = {k: v for k, v in batch.items() if k not in ("model_last_iter", "trace_span_ids", "trace_age_s")}
    return to_device(as_float32(lrn._cap(data)), lrn.device)


def tree_reference(lrn, batch):
    """Check d's yardstick, read before the first step of a fresh RL
    learner: per flax top-level module, in float64 on the card, the norms of
    the parameters, of the raw gradient of the loss on ``batch`` (its own
    autograd pass) and of the first Adam update (``u = g_c / (|g_c| + eps)``
    at count 0, ``g_c`` the norm-clipped gradient), as the tree's keys."""
    import torch

    from distar_tpu_torch.learner import rl_loss
    from distar_tpu_torch.model.convert import flax_names

    opt = lrn.optimizer
    check(opt.count == 0, f"tree reference: the optimizer has stepped {opt.count} times")
    params = opt.params
    total, _ = rl_loss(lrn.model, lrn.loss_cfg, step_batch(lrn, batch), RL_B, RL_T)
    grads = torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)
    names = flax_names(lrn.model)
    by_id = {id(p): n for n, p in lrn.model.named_parameters()}
    mods = [names[by_id[id(p)]].split("/")[1] for p in params]
    g64 = [g.detach().double() for g in grads]
    gn = sum(float((g * g).sum()) for g in g64) ** 0.5
    clip = opt.clip.cfg
    check(clip.type == "norm", f"tree reference: clip {clip.type}")
    scale = 1.0 if gn < clip.threshold else clip.threshold / gn
    sums = {}
    for m, p, g in zip(mods, params, g64):
        u = (g * scale) / ((g * scale).abs() + opt.eps)
        acc = sums.setdefault(m, [0.0, 0.0, 0.0])
        acc[0] += float((p.detach().double() ** 2).sum())
        acc[1] += float((g * g).sum())
        acc[2] += float((u * u).sum())
    lr = opt.lr(0)
    ref = {}
    for m, (p2, g2, u2) in sums.items():
        ref[f"dyn/param_norm/{m}"] = p2 ** 0.5
        ref[f"dyn/grad_norm/{m}"] = g2 ** 0.5
        ref[f"dyn/update_ratio/{m}"] = lr * u2 ** 0.5 / (p2 ** 0.5 + 1e-12)
    p2, g2, u2 = (sum(v[i] for v in sums.values()) for i in range(3))
    ref.update({"dyn/param_norm/total": p2 ** 0.5, "dyn/grad_norm/total": g2 ** 0.5,
                "dyn/update_ratio/total": lr * u2 ** 0.5 / (p2 ** 0.5 + 1e-12)})
    return ref


COUNTED = ("pallas", "xla")  # check h: the strings whose learners count their flops


def flop_counts(learners):
    """Wait for the flop counts the ``COUNTED`` learners started at their
    first step (``learner.perf.aot``); the seconds waited."""
    t0 = time.perf_counter()
    for impl in COUNTED:
        learners[impl]._perf.analysis.join()
    return time.perf_counter() - t0


class DynamicsArm:
    """One arm of check e's A/B: the learner's step rebuilt with the tree
    (and the monitor fed as ``run()`` feeds it: ``every_n`` 10) or without."""

    def __init__(self, lrn, on):
        from distar_tpu_torch.learner.rl_learner import make_rl_train_step

        self.lrn, self.on = lrn, on
        self.step = make_rl_train_step(lrn.model, lrn.loss_cfg, lrn.optimizer, RL_B, RL_T,
                                       dynamics=lrn._dynamics_spec() if on else None)

    def _train(self, batch):
        self.lrn._train_step = self.step
        log = self.lrn._train(batch)
        if self.on:
            self.lrn._dynamics.on_step(self.lrn, log, batch)
        return log


def tree_alone(lrn, batch, calls=10):
    """The tree by itself on the learner's parameters, a stand-in gradient
    and update and the step's batch: host ms a call to enqueue it, ms a call
    to the device's end, and the launches it makes (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distar_tpu_torch.obs.dynamics import DynamicsTree

    params = lrn.optimizer.params
    tree = DynamicsTree(lrn.model, params, lrn._dynamics_spec())
    grads = [torch.randn_like(p) for p in params]
    data = step_batch(lrn, batch)

    def once():
        tree.before_update(params, grads, data)
        return tree.after_update(grads, 1e-5)

    once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        once()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        once()
        torch.cuda.synchronize()
    acts = device_activities(prof)
    return {"host_ms": host_ms, "wall_ms": wall_ms, "device_ms": sum(ms for ms, _ in acts.values()),
            "launches": sum(n for _, n in acts.values()), "leaves": len(params), "modules": len(tree.modules)}


def check_tree(log, ref, cpu_keys, what):
    """Check d's readings of one step's log: the tree's keys those of the
    CPU test's learner, its norms within TREE_TOL of ``ref``, its census 0."""
    keys = {k for k in log if k.startswith("dyn/")}
    check(keys == cpu_keys, f"{what}: tree keys {sorted(keys ^ cpu_keys)} differ from the smoke model's")
    errs = {k: abs(log[k] - v) / max(abs(v), 1e-30) for k, v in ref.items()}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= TREE_TOL, f"{what}: {worst} {log[worst]} against f64 {ref[worst]} "
          f"({errs[worst]:.3g} > {TREE_TOL})")
    census = {k: v for k, v in log.items() if k.startswith("dyn/nonfinite_")}
    check(census and not any(census.values()), f"{what}: a non-zero census on a clean step {census}")
    return {"keys": len(keys), "worst": [worst, errs[worst]], "census": len(census)}


def smoke_tree_keys():
    """The tree's keys of an RL step of the smoke model on the CPU: the
    set tests/test_torch_dynamics.py holds."""
    from distar_tpu_torch.bin.sl_train import SMOKE_MODEL
    from distar_tpu_torch.learner import RLLearner

    lrn = RLLearner({"learner": {"batch_size": 2, "unroll_len": 2, "perf": {"aot": False}},
                     "model": SMOKE_MODEL}, device="cpu")
    return {k for k in lrn._train(next(lrn._dataloader)) if k.startswith("dyn/")}


def profile_route(lrn, batch):
    """Check g: ``POST /learner/profile?steps=2`` to ``lrn`` running
    ``run()`` on ``batch`` with its admin route on; the report."""
    import itertools
    import urllib.request

    for hooks in lrn.hooks._hooks.values():  # no checkpoint at the run's end
        hooks[:] = [h for h in hooks if h.name != "save_ckpt"]
    lrn.set_dataloader(itertools.repeat(batch))
    admin = lrn.start_admin(0)

    def ask():  # the operator's request; the run loop below serves it
        try:
            req = urllib.request.Request(f"http://{admin.host}:{admin.port}/learner/profile?steps=2",
                                         data=b"{}", method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())
        finally:
            lrn.request_stop()

    client = Background(ask).start()
    try:
        lrn.run(lrn.last_iter.val + 10 ** 6)  # on this thread, as a learner process runs it
    finally:
        lrn.request_stop()
        reply = client.result()
        admin.stop()
        lrn.set_dataloader(iter(()))  # closes the run's prefetcher
    check(reply["code"] == 0, f"profile route: {reply}")
    return reply["info"]


def phase_diagnostics(device, smi, learners, batch, ref, first_logs):
    """Checks d-h on the flagship RL learners (4 x 16, f32, kernel overlay
    'pallas' and the 'xla' strings): ``ref`` is ``tree_reference`` of
    ``learners["pallas"]`` before its first step, ``first_logs`` that step's
    log per string. Returns the readings (``seconds`` per check)."""
    import torch

    from distar_tpu_torch.envs.jaxenv.anakin import device_pure_report
    from distar_tpu_torch.obs import get_registry

    lrn, out, secs = learners["pallas"], {}, {}
    # d. the tree on the flagship step
    t0 = time.perf_counter()
    cpu_keys = smoke_tree_keys()
    out["d"] = check_tree(first_logs["pallas"], ref, cpu_keys, "d. the tree on the flagship RL step")
    arms = {"off": DynamicsArm(lrn, False), "on": DynamicsArm(lrn, True)}
    syncs = {}
    for name, arm in arms.items():
        arm._train(batch)  # warm
        rep = device_pure_report(arm._train, batch)
        syncs[name] = rep["offending"]
    check(len(syncs["on"]) == len(syncs["off"]),
          f"d. synchronizing calls a step: tree on {syncs['on']}, off {syncs['off']}")
    out["d"]["syncs"] = {k: len(v) for k, v in syncs.items()}
    print(f"d. the tree on the flagship RL 4 x 16 step ({smi}): {len(cpu_keys)} keys, those of the smoke "
          f"model's step on the CPU; worst |a - b| / |b| against f64 {out['d']['worst']} (tol {TREE_TOL}); "
          f"census 0 over {out['d']['census']} keys; synchronizing calls a step on / off "
          f"{out['d']['syncs']}: {syncs['on']}")
    secs["d"] = time.perf_counter() - t0

    # e. the A/B: dynamics off, then on (every_n 10), in turns
    t0 = time.perf_counter()
    ab, ab_all = step_times(arms, batch, rounds=3, warmup=1)
    out["e"] = {"median_ms": ab, "ms": ab_all, "on_over_off": ab["on"] / ab["off"] - 1,
                "tree_alone": tree_alone(lrn, batch)}
    print(f"e. the tree's A/B ({smi}): RL 4 x 16 step ms, off then on (every_n 10), in turns, 3 each: "
          f"medians {json.dumps(ab)} ({out['e']['on_over_off']:+.2%}); every step {json.dumps(ab_all)}; "
          f"the tree alone on the flagship's parameters {json.dumps(out['e']['tree_alone'])}")
    secs["e"] = time.perf_counter() - t0
    lrn._train_step = arms["on"].step

    # h. perf gauges: the flop count under the 'pallas' and 'xla' strings, MFU, HBM
    t0 = time.perf_counter()
    flops = {impl: learners[impl]._perf.flops_per_step for impl in COUNTED}
    check(flops["pallas"] > 0 and len(set(flops.values())) == 1,
          f"h. distar_perf_flops_per_step differs across the strings: {flops}")
    secs["h"] = time.perf_counter() - t0

    # g. an on-demand profile through the admin route
    t0 = time.perf_counter()
    report = profile_route(lrn, batch)
    shares = {b["bucket"]: b["share"] for b in report["buckets"]}
    busy = report.get("profiler_device_busy_us")
    check(shares.get("entity-attention", 0) > 0 and shares.get("scatter", 0) > 0
          and abs(sum(shares.values()) - 1.0) <= 1e-5,
          f"g. the profile's buckets: {shares}")
    check(busy and abs(report["total_device_us"] - busy) <= 0.1 * busy,
          f"g. the report's device time {report['total_device_us']} us against torch.profiler's busy {busy} us")
    out["g"] = {"buckets": shares, "total_device_ms": report["total_device_us"] / 1e3,
                "profiler_busy_ms": busy / 1e3, "per_step_ms": report["step_time_device_us"] / 1e3,
                "events": report["device_op_events"], "top": {b["bucket"]: b["top_ops"][:2]
                                                               for b in report["buckets"][:4]}}
    print(f"g. POST /learner/profile?steps=2 ({smi}): buckets {json.dumps(shares)}, device "
          f"{out['g']['total_device_ms']:.3f} ms against torch.profiler's busy {out['g']['profiler_busy_ms']:.3f} ms"
          f"\n{report['markdown']}")
    secs["g"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mfu = lrn._perf.last.get("mfu")
    check(mfu is not None and 0 < mfu < 1, f"h. distar_perf_mfu {mfu}")
    before = torch.cuda.memory_stats(device)
    lrn._perf.sample_memory()
    after = torch.cuda.memory_stats(device)
    snap = get_registry().snapshot()
    label = f"gpu:{device.index if device.index is not None else torch.cuda.current_device()}"
    hbm = {"in_use": snap.get(f"distar_perf_hbm_bytes_in_use{{device={label}}}"),
           "peak": snap.get(f"distar_perf_hbm_peak_bytes{{device={label}}}")}
    for gauge, key in (("in_use", "allocated_bytes.all.current"), ("peak", "allocated_bytes.all.peak")):
        lo, hi = sorted((before[key], after[key]))
        check(hbm[gauge] is not None and lo <= hbm[gauge] <= hi,
              f"h. distar_perf_hbm {gauge} {hbm[gauge]} against memory_stats {before[key]}, {after[key]}")
    out["h"] = {"flops_per_step": flops, "mfu": mfu, "peak_flops": lrn._perf.peak, "hbm_bytes": hbm,
                "step_seconds": lrn._perf.last.get("step_seconds")}
    print(f"h. perf gauges ({smi}): distar_perf_flops_per_step {json.dumps(flops)} (equal across the "
          f"strings), distar_perf_mfu {mfu:.6f} of {lrn._perf.peak:.3g} (bf16 peak; the step runs f32), "
          f"HBM gauges {json.dumps(hbm)} = torch.cuda.memory_stats()")
    secs["h"] += time.perf_counter() - t0
    out["seconds"] = secs
    return out


def phase_rl(device, smi, rng, beside=None):
    """The RL and distillation learners on the card (module docstring,
    phase 9). ``beside``: called once the gaps and the strings (its first
    parts, which time nothing) are done, to join work that ran beside them,
    before anything is timed. Returns the launch counts of their paths and
    the measurements."""
    import numpy as np
    import torch

    from distar_tpu_torch.learner import FakeRLDataloader, distill_loss, random_rl_batch, rl_loss
    from distar_tpu_torch.ops import kernels as K

    print(f"rl: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    # one fixed batch of random in-range observations, 68 observed frames
    laps = Laps()
    batch = random_rl_batch(RL_B, RL_T, rng)
    rl_fn = lambda lrn, tb: rl_loss(lrn.model, lrn.loss_cfg, tb, RL_B, RL_T)  # noqa: E731
    zero_obs = next(FakeRLDataloader(RL_B, RL_T))
    # the gap on this phase's batch and on a second seeded apart, both held
    # at GAP_TOL: which kinks a batch puts near zero sets it. (On zero
    # observations, printed and never held, until the diagnostics came, the LSTM amplifies f32
    # rounding: f32 'xla' lay 4e-5 from f64 with every kink pinned.)
    gaps = {what: rl_gap(device, b, rl_fn, what, held) for what, b, held in (
        ("phase batch", batch, True),
        ("seed-0 batch", random_rl_batch(RL_B, RL_T, np.random.default_rng(0)), True))}
    laps("gaps")

    K.reset_launch_counts()
    learners = {impl: rl_learner(device, impl, perf={"aot": impl in COUNTED}) for impl in STRINGS}
    grads = {"rl_zero_obs": hold_strings("rl loss on a FakeRLDataloader batch (zero observations)",
                                         learners, zero_obs, rl_fn),
             "rl_random": hold_strings("rl loss on the random batch", learners, batch, rl_fn,
                                       rl_faults(batch))}
    t_ref = time.perf_counter()
    ref = tree_reference(learners["pallas"], batch)  # check d's yardstick, before the first step
    t_ref = time.perf_counter() - t_ref
    first_logs = steps_agree("rl step", learners, batch)
    t_count = flop_counts(learners)  # check h's counts, over before anything is timed
    gated = gated_step(device, batch)
    launches = dict(K.launch_counts)  # the strings' steps and the gated step
    laps("strings")
    if beside is not None:
        beside()
        laps("earlier work's wait")

    entity_num = batch["entity_num"].reshape(-1)
    inputs, rl_err = train_kernel_grads(K, rng, device, entity_num)
    rl_kernel_ms = train_kernel_times(K, inputs, "rl")
    del inputs
    inputs, student_err = train_kernel_grads(K, rng, device, entity_num, Dh=64, D=16)
    student_kernel_ms = train_kernel_times(K, inputs, "student")
    del inputs
    laps("kernels")

    lrn = rl_learner(device, log_freq=1)
    losses, rl_launches = entry_point(K, lrn, RL_ITERS, "rl entry point (RLLearner.run, flagship)")
    stale = {k: v for k, v in lrn.last_log.items() if k.startswith("staleness/")}
    print(f"rl entry point: staleness after the last step {stale}")
    del lrn
    laps("entry point")
    step_ms, all_ms = step_times(learners, batch, rounds=3, warmup=1)  # cut from 5 and 3 for the drill's time
    memory = {impl: step_memory(lrn, batch)[0] for impl, lrn in learners.items()}
    profiles = {impl: profile_call(lambda: lrn._train(batch)) for impl, lrn in learners.items()}
    laps("timings")
    diagnostics = phase_diagnostics(device, smi, learners, batch, ref, first_logs)
    diagnostics["seconds"]["d"] += t_ref
    diagnostics["seconds"]["h"] += t_count
    del learners
    laps("diagnostics")

    lrn16 = rl_learner(device, dtype="bfloat16")
    log16 = lrn16._train(batch)
    check(finite(log16), f"bf16 RL step: loss {log16['total_loss']} grad_norm {log16['grad_norm']}")
    print(f"rl bf16 step (kernel overlay): total_loss {log16['total_loss']:.4f} "
          f"grad_norm {log16['grad_norm']:.3f}")
    del lrn16

    # the reference's per-GPU shape: 6 trajectories x 64 steps (390 frames)
    big_batch = next(FakeRLDataloader(RL_BIG_B, RL_BIG_T, seed=1))
    big = rl_learner(device, B=RL_BIG_B, T=RL_BIG_T)
    big_ms, big_all = step_times({"pallas": big}, big_batch, rounds=3, warmup=1)
    big_memory, big_log = step_memory(big, big_batch)
    check(finite(big_log), "6 x 64 RL step: a non-finite loss or grad_norm")
    print(f"rl 6 x 64 step (kernel overlay, f32): ms {big_all['pallas']} total_loss "
          f"{big_log['total_loss']:.4f} memory {big_memory}")
    del big, big_batch
    laps("bf16 and 6 x 64")

    # the distillation student, one step per string from the same weights
    students = {impl: distill_learner(device, impl) for impl in STRINGS}
    d_fn = lambda lrn, tb: distill_loss(lrn.model, lrn.loss_cfg, tb, RL_B, RL_T)  # noqa: E731
    K.reset_launch_counts()
    grads["distill_random"] = hold_strings("distill loss on the random batch", students, batch, d_fn,
                                           {"crossed layout": (d_fn, crossed(batch), True)})
    steps_agree("distill step", students, batch)
    d_strings = dict(K.launch_counts)
    lrn = distill_learner(device, log_freq=1)
    d_losses, d_launches = entry_point(K, lrn, DISTILL_ITERS,
                                       "distill entry point (DistillLearner.run, student)")
    del lrn
    d_ms, d_all = step_times(students, batch, rounds=3, warmup=1)  # cut from 5 and 3 for the drill's time
    d_profile = profile_call(lambda: students["pallas"]._train(batch))
    del students
    laps("distill")
    print(f"rl seconds by part: {json.dumps(laps)}")

    paths = {"rl strings": launches, "rl entry point": rl_launches,
             "distill strings": d_strings, "distill entry point": d_launches}
    launches = {name: sum(p[name] for p in paths.values()) for name in launches}
    print(f"rl phase launches, each read from zero around its run: {json.dumps(paths)}")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the RL path")
    frames = RL_T * RL_B
    result = {"step_ms": step_ms, "step_ms_all": all_ms,
              "rl_frames_per_s": {impl: frames / (ms / 1e3) for impl, ms in step_ms.items()},
              "memory": memory, "step_profile": profiles, "gated_moved": gated,
              "entry_point_losses": losses, "staleness": stale, "gradients": grads,
              "distill_entry_point_losses": d_losses,
              "big_step_ms": big_ms["pallas"], "big_step_ms_all": big_all["pallas"],
              "big_frames_per_s": RL_BIG_T * RL_BIG_B / (big_ms["pallas"] / 1e3), "big_memory": big_memory,
              "distill_step_ms": d_ms, "distill_step_ms_all": d_all, "distill_profile": d_profile,
              "rl_kernel_ms": rl_kernel_ms, "student_kernel_ms": student_kernel_ms,
              "rl_kernel_max_abs_err": rl_err, "student_kernel_max_abs_err": student_err,
              "gap": {what: {"a": gap["a"], "b": gap["b"], "c_split": gap["c"]["split"],
                             "d": {k: v for k, v in gap["d"].items()
                                   if k not in ("forward_vs_f64", "grad_at_vs_f64")},
                             "k_pinned": gap["k"]["pinned"], "k_smooth": gap["k"]["smooth_pallas_vs_xla"]}
                      for what, gap in gaps.items()},
              "launches": launches, "launches_by_path": paths, "diagnostics": diagnostics, "laps": laps}
    print(json.dumps({"rl": result}))
    result["batch"] = batch  # the parallel phase's, after the print
    return launches, result


# ----------------------------------------------------------------- RL loop
LOOP_ENV_NUM, LOOP_EPISODE_LOOPS = 8, 300  # the actor: 8 mock envs of 300 game loops
LOOP_ITERS = 2  # the learner: RL_B x RL_T batches from the actors (8 until the replay phase came, 4 until the
# diagnostics, 3 until the parallel phase: the second publication comes at iteration 2 either way)
LOOP_PUBLISH_FREQ = 2  # send_model_freq and send_train_info_freq
LOOP_REFRESH_S = 1.0  # the actor's model_update_interval_s: jobs last a few seconds
LOOP_PROCESS_ITERS = 4  # the learner process: 4 steps of 4 x 4
LOOP_PROCESS_T = 4
SERVE_TOL = dict(atol=2e-4, rtol=1e-3)  # a flush against the 'xla' strings
# tests/test_pipeline.py's league: PFSP only, MP0 against HP0
LOOP_LEAGUE = {
    "branch_probs": {"MainPlayer": {"sp": 0.0, "pfsp": 1.0, "eval": 0.0}},
    "active_players": {
        "player_id": ["MP0"], "checkpoint_path": ["mp0.ckpt"], "pipeline": ["default"], "frac_id": [1],
        "z_path": ["3map.json"], "z_prob": [0.0], "teacher_id": ["T"], "teacher_path": ["t.ckpt"],
        "one_phase_step": [10 ** 9], "chosen_weight": [1.0],
    },
    "historical_players": {
        "player_id": ["HP0"], "checkpoint_path": ["hp0.ckpt"], "pipeline": ["default"], "frac_id": [1],
        "z_path": ["3map.json"], "z_prob": [0.0],
    },
}


class Background:
    """``fn`` on a thread of its own: ``start()``, then ``result()`` joins
    it and returns what ``fn`` returned, or raises what it raised."""

    def __init__(self, fn):
        self._fn, self._out, self._thread = fn, {}, None

    @property
    def started(self):
        return self._thread is not None

    def start(self):
        import threading

        def run():
            try:
                self._out["value"] = self._fn()
            except BaseException as e:  # noqa: BLE001 - raised again by result()
                self._out["error"] = e

        self._thread = threading.Thread(target=run)
        self._thread.start()
        return self

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


SPAWNED = []  # every Spawned job started, killed if the script fails


def adopt_orphans():
    """Makes this process the child subreaper of everything it starts
    (Linux ``prctl(PR_SET_CHILD_SUBREAPER)``): a process whose parent ends
    before it, such as a ``Spawned`` job's own children, becomes a child
    of this one, where ``stop_descendants`` finds it. Returns whether the
    kernel took the setting."""
    import ctypes

    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def descendants(root):
    """{pid: (ppid, state, command line)} of every process below ``root``,
    read from /proc."""
    table = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # ended while the table was read
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]  # the name may hold ") "
        table[int(entry)] = (int(ppid), state, cmd)
    below, parents = {}, {root}
    while parents:
        parents = {pid for pid, (ppid, _, _) in table.items() if ppid in parents and pid not in below}
        below.update({pid: table[pid] for pid in parents})
    return below


def stop_descendants(keep=(), timeout_s=60.0):
    """SIGKILLs every process still running below this one but ``keep``,
    and reaps those that are its children (all of them, once
    ``adopt_orphans`` took). Returns {pid: command line} of the processes
    it found running; the ended ones it only reaps."""
    import signal

    found, deadline = {}, time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        below = {pid: v for pid, v in descendants(os.getpid()).items() if pid not in keep}
        if not below:
            break
        live = {pid: cmd for pid, (_, state, cmd) in below.items() if state not in "ZX"}
        found.update(live)
        for pid in live:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        children = [pid for pid, (ppid, _, _) in below.items() if ppid == os.getpid()]
        for pid in children:
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, 0)
        if not children:  # killed grandchildren are adopted once their parents end
            time.sleep(0.05)
    return found


def stop_resource_tracker():
    """Ends multiprocessing's resource tracker, which the spawned jobs and
    the shared-memory rings share, and waits for it: it unlinks what the
    jobs left registered and exits once no process holds its pipe."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def _spawned_main(fn, args, path, log=None):
    """A ``Spawned`` job's process: ``fn(*args)``'s value, or the text of
    what it raised, pickled to ``path``; then the process ends at once,
    without waiting on threads the entry points left behind (their
    metric writers' queues close under them at an ordinary exit). With
    ``log``, its output (and its own processes') goes to that file."""
    import pickle
    import traceback

    if log is not None:
        fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)
    try:
        out = {"value": fn(*args)}
    except BaseException as e:  # noqa: BLE001 - handed to the parent
        out = {"error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}
    left = stop_descendants()  # the exit below would leave them running
    if left:
        print(f"{fn.__name__}: processes left running, stopped: {json.dumps(left)}", file=sys.stderr)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class Spawned:
    """``fn(*args)`` (a function of this module, arguments that pickle) in a
    spawned process of its own, for in-process entry points that run beside
    the phases: on a thread they would hold this process's interpreter lock
    against the phase's own host-bound steps. ``start()``; ``result()``
    waits and returns what ``fn`` returned, or raises what it raised (its
    traceback printed). With ``log``, the process writes its output to a
    file of its own, which ``result()`` prints whole: its lines do not
    interleave with this process's."""

    def __init__(self, fn, *args, tmp, timeout_s=900.0, log=False):
        self._fn, self._args, self._timeout_s = fn, args, timeout_s
        self._path = os.path.join(tmp, f"spawned_{fn.__name__}_{id(self)}.pkl")
        self._log = os.path.join(tmp, f"spawned_{fn.__name__}_{id(self)}.log") if log else None
        self._proc = None

    @property
    def started(self):
        return self._proc is not None

    def start(self):
        import multiprocessing

        self._proc = multiprocessing.get_context("spawn").Process(
            target=_spawned_main, args=(self._fn, self._args, self._path, self._log), name=self._fn.__name__)
        self._proc.start()
        SPAWNED.append(self)
        return self

    def kill(self):
        """Ends the process if it still runs (the script's failure path),
        and prints the end of its output file."""
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
            if self._log is not None and os.path.exists(self._log):
                with open(self._log) as f:
                    print(f"{self._fn.__name__}, killed; its output ended:\n{f.read()[-20000:]}", file=sys.stderr)

    def result(self):
        import pickle

        self._proc.join(self._timeout_s)
        if self._proc.is_alive():
            self.kill()
            raise SmokeFailure(f"{self._fn.__name__}: still running after {self._timeout_s:.0f} s")
        if self._log is not None and os.path.exists(self._log):
            with open(self._log) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()
        if not os.path.exists(self._path):
            raise SmokeFailure(f"{self._fn.__name__}: its process exited {self._proc.exitcode} with no result")
        with open(self._path, "rb") as f:
            out = pickle.load(f)
        if "error" in out:
            print(out["traceback"], file=sys.stderr)
            raise SmokeFailure(f"{self._fn.__name__} (its own process): {out['error']}")
        return out["value"]


class ThreadCounts(dict):
    """``kernels.launch_counts`` during the loop: every launch also counted
    for the side that made it, the learner (the main thread) or the actor
    (its job thread)."""

    def __init__(self, names):
        super().__init__({n: 0 for n in names})
        self.by_side = {side: {n: 0 for n in names} for side in ("learner", "actor")}

    def __setitem__(self, name, value):
        import threading

        delta = value - self.get(name, 0)
        super().__setitem__(name, value)
        if delta > 0:
            side = "learner" if threading.current_thread() is threading.main_thread() else "actor"
            self.by_side[side][name] += delta


class TimedBatches:
    """The learner's dataloader with the host ms each batch waited for, and
    the first batch kept."""

    def __init__(self, it):
        self.it, self.wait_ms, self.first, self.spans = it, [], None, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.it)
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        self.first = self.first if self.first is not None else batch
        self.spans.append(len(batch.get("trace_span_ids", ())))
        return batch


def time_prefetched(learner):
    """Once ``run()`` wraps the learner's loader in its prefetcher, wrap that
    in ``TimedBatches``: the ms the learner itself waited for each placed
    batch (a ``TimedBatches`` under the prefetcher times the source). The
    returned dict holds it under "it"."""
    from distar_tpu_torch.learner.prefetch import DevicePrefetcher

    above = {}
    real_enable = learner._maybe_enable_prefetch

    def enable():
        real_enable()
        check(isinstance(learner._dataloader, DevicePrefetcher), "the RL learner does not prefetch")
        above["it"] = learner._dataloader = TimedBatches(learner._dataloader)

    learner._maybe_enable_prefetch = enable
    return above


def same_params(model, snapshot):
    """Every parameter of ``model`` bit-equal to its namesake in
    ``snapshot``, a host copy (``to_host``) of a ``state_dict``."""
    import numpy as np

    from distar_tpu_torch.utils.transfer import to_host

    mine = to_host(model.state_dict())
    return all(np.array_equal(v.view(np.uint8), snapshot[k].view(np.uint8)) for k, v in mine.items())


def flush_against_xla(device, cap):
    """One captured loop flush re-run on the 'xla' strings from the same
    weights, carries and Gumbel draws: every active slot's sampled actions
    equal (a differing one tolerated only where the reference's margin
    between its top two noisy logits is within the tolerance) and its
    log-probabilities within SERVE_TOL. Returns the worst |a - b|."""
    import numpy as np
    import torch

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.model import Model, default_model_config
    from distar_tpu_torch.utils import deep_merge_dicts

    cfg = deep_merge_dicts(default_model_config(), overlay("xla", "xla"))
    cfg.use_value_network = False
    model = Model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in cap["state"].items()})
    inf = BatchedInference(model, len(cap["prepared"]), device=device)
    inf.hidden = cap["hidden"]
    want = inf.sample(cap["prepared"], cap["active"], noise=cap["noise"])
    worst, flipped = 0.0, []
    for i, (g, w) in enumerate(zip(cap["out"], want)):
        if cap["active"] is not None and not cap["active"][i]:
            continue
        ga, wa = int(g["action_info"]["action_type"]), int(w["action_info"]["action_type"])
        if ga != wa:
            noisy = w["logit"]["action_type"] + cap["noise"]["action_type"][i].cpu().numpy()
            top = np.sort(noisy)[-2:]
            margin = float(top[1] - top[0])
            flipped.append((i, ga, wa, margin))
            check(margin <= SERVE_TOL["atol"] + SERVE_TOL["rtol"] * abs(float(top[1])),
                  f"rl loop flush vs xla: slot {i} action_type {ga} vs {wa}, margin {margin:.3g}")
            continue
        for h in F.ACTION_HEADS:
            a, b = np.asarray(g["action_logp"][h]), np.asarray(w["action_logp"][h])
            worst = max(worst, float(np.abs(a - b).max()))
            check(np.allclose(a, b, **SERVE_TOL), f"rl loop flush vs xla: {h} logp {a} vs {b}")
    print(f"rl loop: one flush of the loop's observations ({sum(cap['active'] or [])} active lanes) "
          f"against the 'xla' strings: worst |logp a - b| {worst:.3g} (tol {SERVE_TOL}); "
          f"action_type flips within the margin {flipped}")
    return worst


def loop_fleet_health(co):
    """Check a of phase 10: what the four processes' coordinator saw, read
    once the learner has exited and before the SIGTERMs."""
    import urllib.parse

    host, port = co.rsplit(":", 1)
    learner_src = "learner:MP0:0"
    # the reference's learner_mfu_collapse (MFU under 2% of the bf16 peak
    # for 3 passes) may fire, where the learner's MFU reads under 2%: the
    # one rule allowed; /healthz answers 503 while it does
    for _ in range(3):  # the firing set read on both sides of /healthz, unchanged
        _, alerts, _ = get_json(host, port, "/alerts")
        st, hz, hz_ms = get_json(host, port, "/healthz")
        _, again, _ = get_json(host, port, "/alerts")
        if set(again["firing"]) == set(alerts["firing"]):
            break
    firing = set(alerts["firing"])
    name = urllib.parse.quote("distar_perf_mfu{token=rllearner}")
    _, mfu_ts, _ = get_json(host, port, f"/timeseries?name={name}")
    mfu = ((mfu_ts.get("stats") or {}).get(learner_src) or {}).get("last")
    check(firing <= {"learner_mfu_collapse"} and (not firing or (mfu is not None and mfu < 0.02)),
          f"rl loop processes: firing {sorted(firing)} with the learner's MFU {mfu}: "
          f"{json.dumps({n: alerts['rules'][n] for n in firing})}")
    sources = hz.get("sources", {})
    actor_src = next((s for s in sources if s.startswith("actor:")), None)
    check(st == (503 if firing else 200) and hz["status"] == ("firing" if firing else "ok")
          and learner_src in sources and actor_src is not None
          and not sources[learner_src]["stale"] and not sources[actor_src]["stale"],
          f"rl loop processes: /healthz {st} {json.dumps(hz)[:3000]}")
    _, ts, _ = get_json(host, port, "/timeseries?name=distar_learner_iterations_total")
    rate = ((ts["stats"] or {}).get(learner_src) or {}).get("rate")
    check(rate is not None and rate > 0, f"rl loop processes: the learner's iterations {json.dumps(ts)[:2000]}")
    _, traces, _ = get_json(host, port, "/traces?name=trajectory&limit=500")
    rows = [r for r in traces["traces"] if r["source"] == learner_src]
    check(rows, f"rl loop processes: no trajectory trace shipped: {json.dumps(traces)[:2000]}")
    st, body, trace_ms = get_json(host, port, f"/trace/{rows[0]['trace_id']}")
    hops = [h for r in body.get("waterfall", {}).get("spans", ()) for h in r["hops"]]
    check(st == 200 and {"adapter_push", "learner_collate"} <= set(hops) and body["waterfall"]["critical_path"],
          f"rl loop processes: the trajectory's waterfall does not cover the actor's push and the learner's "
          f"collate: {st} {json.dumps(body)[:2000]}")
    print(f"rl loop processes: the learner's MFU {mfu}, firing {sorted(firing)}")
    return {"healthz_ms": hz_ms, "trace_ms": trace_ms, "learner_iterations_rate": rate,
            "learner_mfu": mfu, "firing": sorted(firing),
            "sources": sorted(sources), "series": hz["tsdb"]["series"], "trajectory_traces": len(rows),
            "waterfall_hops": hops, "waterfall_total_s": body["waterfall"]["total_s"]}


def loop_processes(tmp, smi, device):
    """``bin/rl_train.py`` as four processes: coordinator, league, a learner
    of LOOP_PROCESS_ITERS steps and an actor, with fleet health on (the
    learner and the actor ship every second); the learner exits 0 with its
    done line; check a (``loop_fleet_health``) reads the coordinator; then
    SIGTERM ends the actor (exit 0, no traceback), the coordinator and the
    league (exit 0; like the JAX package's servers, they may print the
    stdlib's traceback of the actor hanging up), and the actor and the
    coordinator, not the league, leave a flight bundle (the signal event
    and a registry snapshot) under their save paths' ``flight/``."""
    import signal

    cfg = json.dumps({"model": shallow("pallas", "pallas"), "league": LOOP_LEAGUE})
    procs, out = {}, {}
    dev = ("--device", device.type)

    def start(role, *flags):
        log_path = os.path.join(tmp, f"rl_{role}.log")
        with open(log_path, "w") as log:
            procs[role] = (subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.bin.rl_train", "--type", role, *flags],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log_path)

    def serving(role, timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for ln in open(procs[role][1]).read().splitlines():
                if ln.startswith(f"{role} serving on "):
                    return ln.rsplit(" ", 1)[1]
            check(procs[role][0].poll() is None, f"rl_train {role} exited: {open(procs[role][1]).read()[-2000:]}")
            time.sleep(0.2)
        raise SmokeFailure(f"rl_train {role} never served")

    t0 = time.perf_counter()
    try:
        saves = {role: os.path.join(tmp, f"rl_{role}") for role in ("coordinator", "league", "learner", "actor")}
        start("coordinator", "--port", "0", "--save-path", saves["coordinator"])
        start("league", "--port", "0", "--config", cfg, "--save-path", saves["league"])
        co, lg = serving("coordinator"), serving("league")
        sizes = ("--env-num", "2", "--traj-len", str(LOOP_PROCESS_T), "--batch-size", str(RL_B))
        ship = ("--telemetry-interval-s", "1")
        start("learner", "--coordinator-addr", co, "--league-addr", lg, "--iters", str(LOOP_PROCESS_ITERS),
              "--full-model", "--save-path", saves["learner"], "--config", cfg, *ship, *sizes, *dev)
        start("actor", "--coordinator-addr", co, "--league-addr", lg, "--full-model", "--config", cfg,
              "--save-path", saves["actor"], *ship, *sizes, *dev)
        learner, log_path = procs["learner"]
        wait_ok(learner, log_path, "rl_train learner", timeout=400)
        text = open(log_path).read()
        check(f"learner done: {LOOP_PROCESS_ITERS} iters" in text, f"learner process: {text[-2000:]}")
        out["learner_s"] = time.perf_counter() - t0
        out["health"] = loop_fleet_health(co)
        for role in ("actor", "coordinator", "league"):
            proc, path = procs[role]
            check(proc.poll() is None, f"rl_train {role} exited early: {open(path).read()[-2000:]}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            text = open(path).read()
            check(rc == 0 and (role != "actor" or "Traceback" not in text),
                  f"rl_train {role} after SIGTERM: rc {rc} {text[-2000:]}")
            out[f"{role}_exit_s"] = time.perf_counter() - t1
        bundles = {role: sorted(glob.glob(os.path.join(save, "flight", "flight_*.json")))
                   for role, save in saves.items()}
        check([role for role, b in bundles.items() if b] == ["coordinator", "actor"]
              and all(len(bundles[r]) == 1 for r in ("coordinator", "actor")),
              f"rl loop processes: flight bundles {bundles}, want one each from the coordinator and the actor")
        for role in ("coordinator", "actor"):
            with open(bundles[role][0]) as f:
                bundle = json.load(f)
            check([e for e in bundle["events"] if e["kind"] == "signal"] and bundle["registry_snapshot"],
                  f"rl loop processes: the {role}'s bundle holds no signal event or no registry snapshot")
            out["health"][f"{role}_bundle_bytes"] = os.path.getsize(bundles[role][0])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.perf_counter() - t0
    print(f"rl loop processes ({smi}): coordinator, league, learner ({LOOP_PROCESS_ITERS} steps of "
          f"{RL_B} x {LOOP_PROCESS_T}, the flagship's widths at depth {SHALLOW_LAYERS}, exit 0) and actor (SIGTERM, exit 0, no traceback in its log), fleet health "
          f"on (the coordinator's /healthz ok with both sources fresh, the learner's iterations rising, nothing "
          f"firing, a trajectory's waterfall from the actor's push to the learner's collate; bundles from the "
          f"coordinator and the actor): {json.dumps(out)}")
    return out


def phase_rl_loop(device, smi, tmp, roles):
    """The league-RL loop at the flagship (module docstring, phase 10).
    ``roles``: what ``loop_processes`` returned (e., run beside the rl
    phase). Returns the launch counts of its path (the actor's and the
    learner's) and the measurements."""
    import threading

    import numpy as np
    import torch

    import distar_tpu_torch.comm.adapter as adapter_mod
    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.actor.rollout_plane import InlinePolicyClient
    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.learner import rl_loss
    from distar_tpu_torch.learner.data import as_float32
    from distar_tpu_torch.model import gumbel_noise
    from distar_tpu_torch.obs import get_registry
    from distar_tpu_torch.ops import build
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.utils.transfer import to_host

    t_phase = time.perf_counter()
    laps = Laps()
    args = loop_args(device, tmp)
    loop = rl_train.build_all(args)
    actor, learner, league = loop.actor, loop.learner, loop.league
    actor.cfg.model_update_interval_s = LOOP_REFRESH_S
    mp = loop.player_id
    # the launcher publishes every 4 iterations, past LOOP_ITERS: attach
    # the weight plane again at LOOP_PUBLISH_FREQ
    comm_hooks = ("send_model", "send_model_init", "send_train_info")
    for hooks in learner.hooks._hooks.values():
        hooks[:] = [h for h in hooks if h.name not in comm_hooks]
    learner.attach_comm(learner._dataloader._adapter, mp, league=league,
                        send_model_freq=LOOP_PUBLISH_FREQ, send_train_info_freq=LOOP_PUBLISH_FREQ)
    print(f"rl loop: env_num {LOOP_ENV_NUM}, traj_len {RL_T}, MockEnv({LOOP_EPISODE_LOOPS}), learner "
          f"{RL_B} x {RL_T} x {LOOP_ITERS} iterations, publish and train-info every {LOOP_PUBLISH_FREQ}, "
          f"refresh every {LOOP_REFRESH_S} s, kernel overlay, f32")

    # instruments, all outside the port: the flushes, pushes, publications,
    # refreshes and steps timed; a flush captured; host snapshots of the
    # learner at each publication (on the device they would count in the
    # loop's peak memory)
    stage = ["alone"]
    flushes = {"alone": [], "loop": []}
    captured = {}
    pushes = {"alone": [], "loop": []}
    published, snapshots, loaded, equal = [], {}, [], []
    refresh_ms, check_ms, steps = [], [], []
    tl = threading.local()
    real = {"sample": BatchedInference.sample, "refresh": InlinePolicyClient.refresh,
            "dumps": adapter_mod.dumps}

    def sample(self, prepared, active=None, noise=None):
        cap = None
        busy = active is None or 2 * sum(active) >= len(active)  # half the lanes or more acting
        if noise is None and busy and "flush" not in captured and stage[0] == "loop" and len(flushes["loop"]) >= 4:
            noise = gumbel_noise(self.model.cfg, self.num_slots, self.generator, self.device)
            cap = {"prepared": prepared, "active": active, "noise": {k: v.clone() for k, v in noise.items()},
                   "hidden": tuple((h.clone(), c.clone()) for h, c in self.hidden),
                   "state": to_host(self.model.state_dict())}
        t0 = time.perf_counter()
        out = real["sample"](self, prepared, active, noise)
        flushes[stage[0]].append((time.perf_counter() - t0) * 1e3)
        if cap is not None:
            cap["out"] = out
            captured["flush"] = cap
        return out

    def refresh(self, params, iteration=0):
        real["refresh"](self, params, iteration)
        if self.player_id == mp:
            t0 = time.perf_counter()
            equal.append(("refresh", iteration, same_params(self.engine._infer.model, snapshots[iteration])))
            check_ms.append((time.perf_counter() - t0) * 1e3)  # not the refresh's own

    def dumps(obj, **kw):
        blob = real["dumps"](obj, **kw)
        tl.nbytes = len(blob)
        return blob

    real_push = actor.adapter.push

    def push(token, data, **kw):
        t0 = time.perf_counter()
        port = real_push(token, data, **kw)
        pushes[stage[0]].append(((time.perf_counter() - t0) * 1e3, tl.nbytes))
        return port

    real_pub = actor._params_from_publication

    def from_publication(data):
        loaded.append(data["iter"])
        return real_pub(data)

    real_client_for = actor.plane.client_for

    def client_for(player_id, **kw):
        client = real_client_for(player_id, **kw)
        if player_id == mp and player_id in actor._model_iters:  # built on a publication
            it = actor._model_iters[player_id]
            equal.append(("job start", it, same_params(client.engine._infer.model, snapshots[it])))
        return client

    real_refresh_models = actor._refresh_models

    def refresh_models(*a):
        before, checked = dict(actor._model_iters), sum(check_ms)
        t0 = time.perf_counter()
        reset = real_refresh_models(*a)
        if actor._model_iters != before:
            refresh_ms.append((time.perf_counter() - t0) * 1e3 - (sum(check_ms) - checked))
        return reset

    def timed_send(fn):
        def run(lrn):
            snapshots[lrn.last_iter.val] = to_host(lrn.model.state_dict())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(lrn)
            published.append((lrn.last_iter.val, (time.perf_counter() - t0) * 1e3, tl.nbytes))
        return run

    for hooks in learner.hooks._hooks.values():
        for hook in hooks:
            if hook.name.startswith("send_model"):
                hook._fn = timed_send(hook._fn)
    real_train = learner._train

    def train(data):
        t0 = time.perf_counter()
        log = real_train(data)
        steps.append(((time.perf_counter() - t0) * 1e3, log))
        return log

    learner._train = train
    batches = TimedBatches(learner._dataloader)
    learner.set_dataloader(batches)
    above = time_prefetched(learner)
    actor.adapter.push, actor._params_from_publication = push, from_publication
    actor.plane.client_for, actor._refresh_models = client_for, refresh_models
    BatchedInference.sample, InlinePolicyClient.refresh = sample, refresh
    adapter_mod.dumps = dumps
    counts = ThreadCounts(build.KERNELS)
    real_counts, K.launch_counts = K.launch_counts, counts
    reg = get_registry()
    env_steps = lambda: reg.snapshot().get("distar_env_steps_total", 0.0)  # noqa: E731
    laps("build")
    try:
        # a. the actor alone: one job on a thread, on the actor's own seeded
        # weights (nothing is published yet: the learner's before_run hook
        # publishes when the loop starts)
        job = threading.Thread(target=lambda: actor.run_job(episodes=1))
        t0 = time.perf_counter()
        job.start()
        job.join()
        alone_s = time.perf_counter() - t0
        actor_alone = dict(counts.by_side["actor"])

        # b. the loop: the actor's job loop on the supervisor's thread, the
        # learner on this one; the counts from zero around both
        stage[0] = "loop"
        K.reset_launch_counts()
        counts.by_side = {side: {n: 0 for n in build.KERNELS} for side in ("learner", "actor")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0, pushed0 = env_steps(), len(pushes["loop"])
        t0 = time.perf_counter()
        loop.supervisor.start()
        rl_train._run_learner_supervised(args, learner, LOOP_ITERS)
        loop_s = time.perf_counter() - t0
        launches = {"learner": dict(counts.by_side["learner"]), "actor": dict(counts.by_side["actor"])}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        env_steps_n = env_steps() - steps0
        pushed = len(pushes["loop"]) - pushed0
        batch = batches.first
        in_loop_profile = profile_call(lambda: real_train(batch))  # the actor still running
        loop.supervisor.stop(timeout=120)
    finally:
        K.launch_counts = real_counts
        learner._train = real_train
        BatchedInference.sample, InlinePolicyClient.refresh = real["sample"], real["refresh"]
        adapter_mod.dumps = real["dumps"]
        actor.adapter.push, actor._params_from_publication = real_push, real_pub
        actor.plane.client_for, actor._refresh_models = real_client_for, real_refresh_models
        loop.supervisor.stop(timeout=120)

    # c. what the loop did
    logs = [log for _, log in steps]
    check(learner.last_iter.val == LOOP_ITERS and len(steps) == LOOP_ITERS,
          f"rl loop: {learner.last_iter.val} iterations, {len(steps)} steps")
    # the prefetcher draws up to its depth and one more past the last step
    check(len(batches.spans) >= LOOP_ITERS and set(batches.spans) == {RL_B},
          f"rl loop: the learner's batches carry {batches.spans} actor trajectory spans, want {RL_B} each")
    check(all(finite(lg) for lg in logs), "rl loop: a non-finite loss or grad_norm")
    mp0 = league.all_players[mp]
    elo = league.elo.ratings(start_from_zero=False)
    check(mp0.total_game_count > 0 and league.elo.game_count > 0, "rl loop: the league counted no game")
    check(any(v != league.elo.init_elo for v in elo.values()) and "HP0" in mp0.payoff.get_text(),
          f"rl loop: ELO {elo} or the payoff unmoved: {mp0.payoff.get_text()}")
    check(mp0.total_agent_step == RL_B * RL_T * LOOP_PUBLISH_FREQ * (LOOP_ITERS // LOOP_PUBLISH_FREQ),
          f"rl loop: the league saw {mp0.total_agent_step} train steps")
    pulled = sorted(set(loaded))
    check(len(pulled) >= 2, f"rl loop: the actor loaded publications {pulled}, want two or more")
    check(equal and all(ok for _, _, ok in equal),
          f"rl loop: the actor's policy weights against the learner's at the publication: {equal}")
    for side in ("learner", "actor"):
        for name in ("masked_attention", "scatter_add_connection"):
            check(launches[side][name] > 0, f"rl loop: {name} never launched on the {side}'s side")
    check(all(v > 0 for k, v in actor_alone.items() if k != "scatter_add_onehot"),
          f"rl loop: the actor's job alone launched {actor_alone}")

    rl_fn = lambda lrn, tb: rl_loss(lrn.model, lrn.loss_cfg, tb, RL_B, RL_T)  # noqa: E731
    held = as_float32({k: v for k, v in batch.items() if k not in ("trace_span_ids", "trace_age_s")})
    step_alone, _ = step_times({"pallas": learner}, held, rounds=3, warmup=1)
    laps("alone, loop and checks")
    # c'. the fleet-health drill on this learner and actor
    finish_health = phase_health(
        device, smi, tmp, loop, args, held,
        baseline={"step_ms": {"alone_median": step_alone["pallas"]},
                  "flush_ms": {"alone_median": statistics.median(flushes["alone"][2:] or flushes["alone"])}})
    del learner, loop, snapshots

    health_launches, health = finish_health()
    del finish_health
    laps("drill")
    # d. the loop's flush and step held against the 'xla' strings
    check("flush" in captured, "rl loop: no flush captured")
    flush_err = flush_against_xla(device, captured.pop("flush"))
    strings = hold_strings("rl loop: the RL loss on an actor-made batch", OneLearner(rl_learner(device)), held,
                           rl_fn, hold_gradient=False)
    strings["probe"] = hold_loop_batch(device, held, rl_fn, strings["strings"])
    laps("hold against xla")
    print(f"rl loop seconds by part (e., the roles as processes, {roles.get('seconds', 0):.1f} s beside the "
          f"rl phase): {json.dumps(laps)}")

    flush_alone = flushes["alone"][2:] or flushes["alone"]
    result = {
        "seconds": time.perf_counter() - t_phase, "loop_s": loop_s, "actor_job_alone_s": alone_s,
        "env_steps_per_s": env_steps_n / loop_s,
        "frames_made_per_s": pushed * RL_T / loop_s,
        "frames_consumed_per_s": LOOP_ITERS * RL_B * RL_T / loop_s,
        "trajectories_pushed": pushed,
        "flush_ms": {"loop_median": statistics.median(flushes["loop"]), "alone_median":
                     statistics.median(flush_alone), "loop_n": len(flushes["loop"])},
        "step_ms": {"loop_median": statistics.median(ms for ms, _ in steps), "loop_all": [ms for ms, _ in steps],
                    "alone_median": step_alone["pallas"]},
        "data_wait_ms": {"median": statistics.median(batches.wait_ms), "all": batches.wait_ms,
                         "learner_median": statistics.median(above["it"].wait_ms),
                         "learner_all": above["it"].wait_ms},
        "publish_ms": [{"iter": it, "ms": ms, "bytes": nb} for it, ms, nb in published],
        "refresh_ms": refresh_ms,
        "push": {"ms_median": statistics.median(ms for ms, _ in pushes["loop"]),
                 "bytes_median": statistics.median(nb for _, nb in pushes["loop"])},
        "peak_memory_gb": peak_gb, "in_loop_step_profile": in_loop_profile,
        "losses": [lg["total_loss"] for lg in logs], "publications_loaded": pulled,
        "weights_checked": [(where, it) for where, it, _ in equal],
        "league": {"games": mp0.total_game_count, "elo": elo, "train_steps": mp0.total_agent_step},
        "launches": launches, "actor_job_alone_launches": actor_alone,
        "flush_vs_xla_worst_logp": flush_err, "strings": strings["strings"],
        "strings_probe": strings["probe"], "processes": roles,
        "health": health, "health_launches": health_launches, "laps": laps,
    }
    print(f"rl loop ({smi}): " + json.dumps({k: v for k, v in result.items()
                                             if k not in ("in_loop_step_profile", "health")}))
    print(f"rl loop: a learner step profiled inside the loop (the actor running): "
          f"{json.dumps(in_loop_profile)}")
    total = {n: launches["learner"][n] + launches["actor"][n] for n in build.KERNELS}
    return total, result


HEALTH_STALL_WINDOW_S = 2.0  # the drill's rulebook: a stall is 2 s of flat counter
HEALTH_SAMPLE_S, HEALTH_EVAL_S = 0.1, 0.2  # registry sampling and rulebook cadence
HEALTH_POISONED = 3  # NaN-loss steps, then as many clean ones
HEALTH_STALL_S = 3.0  # every mock env's next step sleeps this long
HEALTH_SHIPS = 8  # ship_once calls timed for each source


def wait_for(cond, timeout, what):
    """Poll ``cond`` every 20 ms; fail naming ``what`` at ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"{what} within {timeout} s")
        time.sleep(0.02)


def get_json(host, port, path):
    """(HTTP status, JSON body, ms) of one GET."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=30) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, json.loads(body), (time.perf_counter() - t0) * 1e3


def ship_timings(source, coord, endpoint=None):
    """Ms of HEALTH_SHIPS ``ship_once`` calls of this process's registry to
    the coordinator at ``coord`` under ``source`` (p50 and max), and the
    serialized bytes of one message."""
    from distar_tpu_torch.comm import serializer
    from distar_tpu_torch.obs import TelemetryShipper

    ship = TelemetryShipper(source, coordinator_addr=coord, interval_s=60.0, endpoint=endpoint)
    ms = []
    for _ in range(HEALTH_SHIPS):
        t0 = time.perf_counter()
        check(ship.ship_once() > 0, f"{source}: a ship recorded nothing")
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"p50_ms": statistics.median(ms), "max_ms": max(ms), "bytes": len(serializer.dumps(ship._message()))}


def loop_args(device, tmp, iters=LOOP_ITERS):
    """The flags of phase 10's ``--type all`` loop at the flagship."""
    from distar_tpu_torch.bin import rl_train

    args = rl_train.parser().parse_args([
        "--type", "all", "--full-model", "--iters", str(iters), "--batch-size", str(RL_B),
        "--traj-len", str(RL_T), "--env-num", str(LOOP_ENV_NUM),
        "--episode-game-loops", str(LOOP_EPISODE_LOOPS), "--save-path", os.path.join(tmp, "rl_loop"),
        "--device", device.type,
        "--config", json.dumps({"model": overlay("pallas", "pallas"), "league": LOOP_LEAGUE,
                                "learner": {"log_freq": 1}})])
    rl_train._resolve_args(args)
    return args


def health_loop(device, tmp):
    """Phase 10's learner and actor for ``--only health``: built by
    ``rl_train.build_all`` on phase 10's flags, the actor's jobs played on a
    thread until the learner draws an actor-made batch, which is handed on
    as phase 10 hands it to the drill (f32, without its trace keys)."""
    import threading

    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.learner.data import as_float32

    args = loop_args(device, tmp)
    loop = rl_train.build_all(args)
    stop = threading.Event()

    def jobs():
        while not stop.is_set():
            loop.actor.run_job(episodes=1)

    job = Background(jobs).start()
    try:
        batch = next(loop.learner._dataloader)
    finally:
        stop.set()
        job.result()
    return loop, args, as_float32({k: v for k, v in batch.items() if k not in ("trace_span_ids", "trace_age_s")})


def sampler_ab(learner, batch, repeats=3):
    """The learner's step ms (``step_times``, 3 rounds after a warm-up) with
    no fleet health, with the drill's rulebook sampled and evaluated at the
    launchers' default cadence (1 s, 2 s) and at the drill's (0.1 s, 0.2 s),
    the three in turns ``repeats`` times: {case: every median}."""
    from distar_tpu_torch.obs import default_rulebook, init_fleet_health

    cases = {"off": None, "default": (1.0, 2.0), "drill": (HEALTH_SAMPLE_S, HEALTH_EVAL_S)}
    out = {case: [] for case in cases}
    for _ in range(repeats):
        for case, cadence in cases.items():
            fleet = None if cadence is None else init_fleet_health(
                default_rulebook(("learner", "actor"), stall_window_s=HEALTH_STALL_WINDOW_S),
                sample_interval_s=cadence[0], eval_interval_s=cadence[1])
            try:
                out[case].append(step_times({"pallas": learner}, batch, rounds=3, warmup=1)[0]["pallas"])
            finally:
                if fleet is not None:
                    fleet.stop()
    return out


def learner_snapshot(learner):
    """Device copies of a learner's parameters and Adam state (the drill
    puts them back after its poisoned steps)."""
    opt = learner.optimizer
    return {"params": [p.detach().clone() for p in opt.params], "mu": [t.clone() for t in opt.mu],
            "nu": [t.clone() for t in opt.nu], "count": opt.count}


def learner_restore(learner, snap):
    import torch

    opt = learner.optimizer
    with torch.no_grad():
        for key in ("params", "mu", "nu"):
            for dst, src in zip(opt.params if key == "params" else getattr(opt, key), snap[key]):
                dst.copy_(src)
    opt.count = snap["count"]


def stepreplay_process(tmp, bundle_path):
    """Check f's replay: ``python -m distar_tpu_torch.tools.stepreplay`` on
    the drill's bundle, on the card, as a process; its verdict."""
    log_path = os.path.join(tmp, "stepreplay.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, "-m", "distar_tpu_torch.tools.stepreplay", "--bundle", bundle_path,
                             "--json", "--workdir", os.path.join(tmp, "stepreplay")],
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, timeout=300).returncode
    text = open(log_path).read()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    check(rc == 0 and lines, f"stepreplay: exit {rc}: {text[-3000:]}")
    verdict = json.loads(lines[-1])
    check(verdict["ok"] and verdict["nonfinite_reproduced"] and verdict["provenance_confirmed"]
          and verdict["deterministic"] and verdict["device"].startswith("cuda"), f"stepreplay: {verdict}")
    verdict["seconds"] = time.perf_counter() - t0
    print(f"f. python -m distar_tpu_torch.tools.stepreplay on the drill's bundle, on the card: {json.dumps(verdict)}")
    verdict["opsctl_dynamics"] = opsctl_dynamics(tmp, bundle_path)
    return verdict


def opsctl(tmp, name, *argv, timeout=120):
    """``python -m distar_tpu_torch.tools.opsctl`` as a process: (exit
    code, its standard output, seconds)."""
    t0 = time.perf_counter()
    log = os.path.join(tmp, f"opsctl_{name}.log")
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-m", "distar_tpu_torch.tools.opsctl", *argv], cwd=REPO,
                            env={**os.environ, "PYTHONPATH": REPO}, stdout=f, stderr=subprocess.DEVNULL,
                            timeout=timeout).returncode
    return rc, open(log).read(), time.perf_counter() - t0


def opsctl_dynamics(tmp, bundle_path):
    """``opsctl dynamics --dir`` on the drill's black-box directory lists
    its bundle, and ``--inspect`` names the port's stepreplay; exit 0 each,
    as the JAX ``opsctl`` exits on a directory holding a bundle."""
    bundle_id = os.path.basename(bundle_path)
    rc, text, list_s = opsctl(tmp, "dynamics", "dynamics", "--dir", os.path.dirname(bundle_path))
    check(rc == 0 and bundle_id in text, f"opsctl dynamics: exit {rc}: {text[-2000:]}")
    rc, text, inspect_s = opsctl(tmp, "dynamics_inspect", "dynamics", "--dir", os.path.dirname(bundle_path),
                                 "--inspect", bundle_id)
    check(rc == 0 and f"replay: python -m distar_tpu_torch.tools.stepreplay --bundle {bundle_path}" in text,
          f"opsctl dynamics --inspect: exit {rc}: {text[-2000:]}")
    out = {"list_s": list_s, "inspect_s": inspect_s}
    print(f"f. python -m distar_tpu_torch.tools.opsctl dynamics on the drill's bundle: {json.dumps(out)}")
    return out


def phase_health(device, smi, tmp, loop, args, batch, baseline=None):
    """Check c of phase 10 (module docstring): the fleet-health fault drill
    on rl_loop's flagship learner and actor, f32, the kernel overlay.
    ``batch`` is an actor-made batch the learner trains on; ``baseline``
    the loop's step and flush ms alone, without fleet health. The two faults
    run one after the other, each under a fleet health installed for it:
    the NaN loss with the actor idle, the stall with the learner idle (a
    job's start, the only gap in a running actor's env steps, lasts about as
    long as the 2 s stall window). The actor is asked to stop at the end;
    returns ``finish``, which waits for its last job (the caller starts
    work that launches no kernel in this process first), so the counts are
    read whole, then checks them and returns the launch counts of the path
    and the readings (``seconds``: the drill before ``finish``)."""
    import itertools
    import math
    import threading

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.comm import CoordinatorServer
    from distar_tpu_torch.envs import MockEnv
    from distar_tpu_torch.learner.prefetch import DevicePrefetcher
    from distar_tpu_torch.obs import TelemetryShipper, default_rulebook, get_flight_recorder, get_registry, \
        init_fleet_health
    from distar_tpu_torch.ops import build
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.resilience import AlertRemediator, ChaosInjector, Supervisor

    t_phase = time.perf_counter()
    learner, actor = loop.learner, loop.actor
    drill_hooks = ("send_model", "send_model_init", "send_train_info", "save_ckpt")
    for hooks in learner.hooks._hooks.values():  # the drill publishes and saves nothing
        hooks[:] = [h for h in hooks if h.name not in drill_hooks]
    learner.set_dataloader(itertools.repeat(batch))
    recorder, reg = get_flight_recorder(), get_registry()
    transitions = []

    def install(start=True):
        fleet = init_fleet_health(default_rulebook(("learner", "actor"), stall_window_s=HEALTH_STALL_WINDOW_S),
                                  start=start, sample_interval_s=HEALTH_SAMPLE_S, eval_interval_s=HEALTH_EVAL_S)
        fleet.evaluator.add_transition_callback(lambda e: transitions.append((time.perf_counter(), e)))
        return fleet

    srv = CoordinatorServer(port=0)  # its health routes answer from the installed fleet
    srv.start()
    chaos = ChaosInjector(seed=0)
    supervisor = Supervisor(policy=rl_train._restart_policy(args))
    armed = {"learner": False, "actor": False}
    captured, steps, flush_ms, restarts = {}, [], [], []
    real = {"attention": K.masked_attention, "scatter": K.scatter_add_connection,
            "sample": BatchedInference.sample, "train": learner._train}

    def side():
        return "learner" if threading.current_thread() is threading.main_thread() else "actor"

    def attention(q, k, v, mask):
        key = (side(), "masked_attention")
        if armed[key[0]] and key not in captured:
            captured[key] = [t.detach().clone() for t in (q, k, v, mask)]
        return real["attention"](q, k, v, mask)

    def scatter(emb, idx, hw):
        key = (side(), "scatter_add_connection")
        if armed[key[0]] and key not in captured:
            captured[key] = (emb.detach().clone(), idx.clone(), hw)
        return real["scatter"](emb, idx, hw)

    def sample(self, prepared, active=None, noise=None):
        t0 = time.perf_counter()
        out = real["sample"](self, prepared, active, noise)
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def train(data):
        t0 = time.perf_counter()
        log = real["train"](data)
        steps.append((time.perf_counter() - t0) * 1e3)
        return log

    def actor_loop(ctx):  # the job loop of ``--type all``
        while not ctx.should_exit:
            actor.run_job(episodes=1)

    def on_restart(error):
        armed["actor"] = True  # its first flush after the restart is captured
        # the stall ends with the job it starved: faults of its budget that
        # no env of that job drew (a slow host) must not stall the restarted
        # one (seen on the card: a second firing)
        chaos.restore()
        restarts.append((time.perf_counter(), time.time()))

    def firings(rule):
        return [t for t, e in transitions if e["rule"] == rule and e["state"] == "firing"]

    def history():
        return [(round(t - t_phase, 3), e["rule"], e["state"], e["value"]) for t, e in transitions]

    def env_steps():
        return reg.snapshot().get("distar_env_steps_total", 0.0)

    supervisor.add("actor", actor_loop, on_restart=on_restart)
    counts = ThreadCounts(build.KERNELS)
    real_counts, K.launch_counts = K.launch_counts, counts
    K.masked_attention, K.scatter_add_connection = attention, scatter
    BatchedInference.sample, learner._train = sample, train
    fleet = None
    out = {}

    def close():
        if fleet is not None:
            fleet.stop()
        # a failed drill waits for the actor's job too: a thread still on the
        # card when the process exits aborts it
        supervisor.stop(timeout=120)
        chaos.restore()
        K.launch_counts = real_counts
        K.masked_attention, K.scatter_add_connection = real["attention"], real["scatter"]
        BatchedInference.sample, learner._train = real["sample"], real["train"]
        if isinstance(learner._dataloader, DevicePrefetcher):
            learner._dataloader.close()
        srv.stop()

    try:
        # NaN, the actor idle: a NaN written into a core_lstm parameter
        # before each of 3 steps; the loss and the gradient rules fire once,
        # the gradient rule's exemplar the black-box bundle of the first
        # poisoned step, /healthz 503, a dump; the state from before the
        # poison restored, clean steps, both rules clear
        monitor = learner._dynamics
        # the tree's gauges exported every step for the drill (every_n 10
        # would leave the last poisoned census standing through the clean steps)
        every_n, monitor.every_n = monitor.every_n, 1
        bundles0 = monitor.bundles_written
        fleet = install()
        state = lambda rule: fleet.evaluator.alerts()["rules"][rule]["state"]  # noqa: E731
        it0 = learner.last_iter.val
        clean = learner_snapshot(learner)
        chaos.poison_module(learner, "core_lstm", n=HEALTH_POISONED)
        t_poison = time.perf_counter()
        learner.run(it0 + HEALTH_POISONED)
        wait_for(lambda: state("learner_loss_nonfinite") == "firing" and state("learner_grad_nonfinite") == "firing",
                 30, "health: learner_loss_nonfinite and learner_grad_nonfinite firing")
        fire_s = firings("learner_loss_nonfinite")[0] - t_poison
        grad_fire_s = firings("learner_grad_nonfinite")[0] - t_poison
        check(monitor.bundles_written == bundles0 + 1, f"health: {monitor.bundles_written - bundles0} black-box "
              f"bundles for {HEALTH_POISONED} poisoned steps, want 1 (debounced)")
        bundle_id = os.path.basename(monitor.last_bundle_path)
        exemplars = [e.get("exemplar_trace_id") for e in fleet.evaluator.alerts()["history"]
                     if e["rule"] == "learner_grad_nonfinite" and e["state"] == "firing"]
        check(exemplars == [f"blackbox:{bundle_id}"],
              f"health: learner_grad_nonfinite's exemplar {exemplars}, want blackbox:{bundle_id}")
        blackbox = {"id": bundle_id, "path": monitor.last_bundle_path, "capture_ms": monitor.last_capture_s * 1e3,
                    "bytes": os.path.getsize(monitor.last_bundle_path), "grad_fire_s": grad_fire_s}
        status, hz, hz_ms = get_json(srv.host, srv.port, "/healthz")
        check(status == 503 and hz["status"] == "firing" and "learner_loss_nonfinite" in hz["firing"]
              and "learner_grad_nonfinite" in hz["firing"],
              f"health: /healthz while the NaN rules fire: {status} {hz.get('firing')}")
        hz_ms_all = [hz_ms] + [get_json(srv.host, srv.port, "/healthz")[2] for _ in range(4)]
        t0 = time.perf_counter()
        path = recorder.dump(os.path.join(tmp, "health_flight"), reason="chip_smoke health drill")
        dump_s = time.perf_counter() - t0
        bundle_bytes = os.path.getsize(path)
        with open(path) as f:
            bundle = json.load(f)
        states = [e.get("state") for e in bundle["events"]
                  if e["kind"] == "alert" and e.get("rule") == "learner_loss_nonfinite"]
        check(states[-2:] == ["warning", "firing"] and math.isnan(bundle["registry_snapshot"]["distar_learner_loss"]),
              f"health: the bundle holds the transitions {states} and distar_learner_loss "
              f"{bundle['registry_snapshot'].get('distar_learner_loss')}")
        chaos.restore()
        learner_restore(learner, clean)
        armed["learner"] = True  # the first clean step's kernel inputs
        learner.run(it0 + 2 * HEALTH_POISONED)
        wait_for(lambda: state("learner_loss_nonfinite") == "ok" and state("learner_grad_nonfinite") == "ok", 30,
                 "health: learner_loss_nonfinite and learner_grad_nonfinite back to ok")
        check(len(firings("learner_loss_nonfinite")) == 1 and len(firings("learner_grad_nonfinite")) == 1
              and [e["remaining"] for e in chaos.events] == [2, 1, 0],
              f"health: learner_loss_nonfinite fired {len(firings('learner_loss_nonfinite'))} times and "
              f"learner_grad_nonfinite {len(firings('learner_grad_nonfinite'))} for {HEALTH_POISONED} "
              f"poisoned steps: {history()}")
        check(math.isfinite(learner.last_log["total_loss"]), "health: the last clean step's loss")
        # of the learner's numeric and perf rules, the two NaN rules fire,
        # and the reference's learner_mfu_collapse (distar_perf_mfu under 2%
        # of the bf16 peak for 3 passes) where MFU reads under 2%, and only then
        mfu = reg.snapshot().get(f"distar_perf_mfu{{token={learner.name}}}")
        numeric = {"learner_loss_nonfinite", "learner_grad_nonfinite", "learner_grad_explosion",
                   "learner_entropy_collapse", "learner_mfu_collapse"}
        fired = {e["rule"] for _, e in transitions if e["state"] == "firing"} & numeric
        want = {"learner_loss_nonfinite", "learner_grad_nonfinite"} | (
            {"learner_mfu_collapse"} if mfu is not None and mfu < 0.02 else set())
        check(fired == want, f"health: fired {sorted(fired)} with MFU {mfu}, want {sorted(want)}: {history()}")
        blackbox["mfu"] = mfu
        monitor.every_n = every_n
        fleet.stop()

        # starvation, the learner idle: the actor's job loop under the
        # supervisor and the remediator, a fleet installed once its env
        # steps flow, then every env's next step sleeps HEALTH_STALL_S; the
        # rule fires once, the job loop restarts once, steps resume
        supervisor.start()
        steps0 = env_steps()
        wait_for(lambda: env_steps() > steps0 + LOOP_ENV_NUM, 180, "health: the actor's env steps flowing")
        del transitions[:]
        # a window's worth of history sampled before the rules are evaluated,
        # as in a fleet that has been running: over a shorter one the rule
        # reads two equal samples as a stall, so a pause of 0.6 s at the
        # install (a job's start, a slow flush) fired it (seen on the card)
        fleet = install(start=False)
        fleet.sampler.start()
        t_fleet = time.perf_counter()
        wait_for(lambda: time.perf_counter() - t_fleet > HEALTH_STALL_WINDOW_S, 30, "health: a window sampled")
        AlertRemediator(supervisor, {"actor_env_starvation": "actor"}).attach(fleet.evaluator)
        fleet.start()
        # then a window evaluated with the env steps flowing: nothing fires
        t_eval = time.perf_counter()
        wait_for(lambda: time.perf_counter() - t_eval > HEALTH_STALL_WINDOW_S
                 and state("actor_env_starvation") == "ok", 30, "health: the actor's env steps recorded, ok")
        check(not firings("actor_env_starvation") and not restarts,
              f"health: actor_env_starvation before the stall: {history()}")
        t_stall, wall_stall = time.perf_counter(), time.time()
        chaos.patch(MockEnv, "step", chaos.wrap(MockEnv.step, op="env_step", delay_p=1.0,
                                                delay_s=HEALTH_STALL_S, max_faults=LOOP_ENV_NUM))
        wait_for(lambda: restarts, 180, "health: the starved actor restarted")
        stall_fire_s = firings("actor_env_starvation")[0] - t_stall
        restart_s = restarts[0][0] - t_stall

        def after_restart():
            return [p for p in fleet.store.points("distar_env_steps_total", window_s=60.0)["local"]
                    if p[0] > restarts[0][1]]

        wait_for(lambda: len(after_restart()) >= 2 and after_restart()[-1][1] > after_restart()[0][1], 120,
                 "health: env steps after the restart")
        wait_for(lambda: ("actor", "masked_attention") in captured and ("actor", "scatter_add_connection") in captured,
                 60, "health: the restarted actor's first flush")
        pts = after_restart()
        rate_after = (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])
        fleet.stop()
        supervisor.stop(timeout=0)  # the actor ends its job while the wire is timed below
        remediations = reg.snapshot().get("distar_resilience_remediations_total{rule=actor_env_starvation}", 0.0)
        task_restarts = [e for e in recorder.events(kind="task_restart")
                         if e.get("task") == "actor" and e["ts"] >= wall_stall]
        check(len(firings("actor_env_starvation")) == 1 and remediations == 1 and len(task_restarts) == 1
              and task_restarts[0]["reason"] == "remediation:alert:actor_env_starvation",
              f"health: {len(firings('actor_env_starvation'))} firings of actor_env_starvation, {remediations:g} "
              f"remediations, restart events {task_restarts}: {history()}")
        all_pts = fleet.store.points("distar_env_steps_total", window_s=120.0)["local"]
        rises = [p for a_, p in zip(all_pts, all_pts[1:]) if p[1] > a_[1]]
        gaps = [b_[0] - a_[0] for a_, b_ in zip(rises, rises[1:])]
        gaps_before = [b_[0] - a_[0] for a_, b_ in zip(rises, rises[1:]) if b_[0] <= wall_stall]

        # the coordinator's store and the wire, read after the drill
        ships = {"learner": ship_timings("learner:health", (srv.host, srv.port)),
                 "actor": ship_timings("actor:health", (srv.host, srv.port))}
        msg = TelemetryShipper("ingest:health", ingest=fleet.ingest)._message()
        ingest_ms = []
        for _ in range(HEALTH_SHIPS):
            t0 = time.perf_counter()
            fleet.ingest.ingest(msg)
            ingest_ms.append((time.perf_counter() - t0) * 1e3)
        store = {"series": fleet.store.stats()["series"], "sources": len(fleet.store.sources())}
        drill_s = time.perf_counter() - t_phase
    except BaseException:
        close()
        raise

    def finish():
        """The actor's last job over, every flush and step is whole in the
        counts: read and checked exactly, the captured inputs held against
        the plain versions, the readings printed and returned."""
        t0 = time.perf_counter()
        try:
            supervisor.join(timeout=120)
            task = supervisor.status()["actor"]
            check(not task["alive"], f"health: the drill's actor is still in a job 120 s after its stop: {task}")
            launches = {s: dict(counts.by_side[s]) for s in ("learner", "actor")}
            n_flush = len(flush_ms)
        finally:
            close()
        join_s = time.perf_counter() - t0
        # a step: one attention call a layer, one scatter; a flush: as many
        # for the policy and for its teacher
        layers = int(learner.model_cfg.encoder.entity.layer_num)
        n_steps = len(steps)
        want_step = {"masked_attention": layers, "scatter_add_connection": 1, "scatter_add_onehot": 0}
        want_flush = {"masked_attention": 2 * layers, "scatter_add_connection": 2, "scatter_add_onehot": 0}
        check(n_steps == 2 * HEALTH_POISONED and n_flush > 0, f"health: {n_steps} steps and {n_flush} flushes")
        check(launches["learner"] == {n: want_step[n] * n_steps for n in build.KERNELS},
              f"health: the learner launched {launches['learner']} in {n_steps} steps, want {want_step} a step")
        check(launches["actor"] == {n: want_flush[n] * n_flush for n in build.KERNELS},
              f"health: the actor launched {launches['actor']} in {n_flush} flushes, want {want_flush} a flush")
        errs = path_kernels_against_plain(K, captured, what="health drill")
        out.update({
            "seconds": drill_s, "last_job_join_s": join_s,
            "nan_fire_s": fire_s, "stall_fire_s": stall_fire_s, "stall_to_restart_s": restart_s,
            "env_steps_per_s_after_restart": rate_after, "max_env_step_gap_s": max(gaps or [0.0]),
            "max_env_step_gap_before_stall_s": max(gaps_before or [0.0]),
            "healthz_ms": {"p50": statistics.median(hz_ms_all), "max": max(hz_ms_all)},
            "dump_s": dump_s, "bundle_bytes": bundle_bytes, "blackbox": blackbox, "ship": ships,
            "ingest_ms": {"p50": statistics.median(ingest_ms), "max": max(ingest_ms)}, "store": store,
            "step_ms": {"health_median": statistics.median(steps), "all": steps,
                        **({"alone_median_without": baseline["step_ms"]["alone_median"]} if baseline else {})},
            "flush_ms": {"health_median": statistics.median(flush_ms), "n": n_flush,
                         **({"alone_median_without": baseline["flush_ms"]["alone_median"]} if baseline else {})},
            "launches": launches,
            "launches_per_step": want_step, "launches_per_flush": want_flush,
            "kernel_max_abs_err": errs, "transitions": history(),
        })
        print(f"f. the drill's black box ({smi}): {HEALTH_POISONED} steps with a NaN in a core_lstm parameter "
              f"fired learner_grad_nonfinite once {grad_fire_s:.3f} s after the first, its exemplar "
              f"blackbox:{bundle_id}; captured in {blackbox['capture_ms']:.1f} ms, {blackbox['bytes']} bytes; "
              f"learner_mfu_collapse at MFU {mfu}: {'fired' if 'learner_mfu_collapse' in fired else 'not fired'}")
        print(f"health drill ({smi}): rulebook (learner, actor) at a {HEALTH_STALL_WINDOW_S:g} s stall window, "
              f"sampled every {HEALTH_SAMPLE_S:g} s, evaluated every {HEALTH_EVAL_S:g} s; {HEALTH_POISONED} NaN "
              f"steps: learner_loss_nonfinite fired once {fire_s:.3f} s after the first poisoned step, /healthz 503 "
              f"({statistics.median(hz_ms_all):.2f} ms), a bundle of {bundle_bytes} bytes dumped in {dump_s:.3f} s with "
              f"the transitions and the NaN loss, ok after {HEALTH_POISONED} clean steps; a {HEALTH_STALL_S:g} s env "
              f"stall: actor_env_starvation fired once {stall_fire_s:.3f} s after it, the AlertRemediator restarted the "
              f"job loop once {restart_s:.3f} s after it, env steps resumed at {rate_after:.2f}/s: " + json.dumps(out))
        return {n: launches["learner"][n] + launches["actor"][n] for n in build.KERNELS}, out

    return finish


def hold_loop_batch(device, batch, loss_fn, dist, what="rl loop batch"):
    """ROADMAP Queue 3 item 1 on an actor-made batch, which differs in every
    run: the kernel strings' whole gradients, read unpinned (``dist``,
    printed by ``hold_strings``), are held within GRAD_TOL; where one reads
    above it, the batch is saved (``torch.save``, under ``chiprun_out/``,
    the path printed) and held by the probe instead (``rl_gap``, held): the
    strings within GAP_TOL of each other with every ReLU, max-pool and UPGO
    decision pinned to an f64 run's, and in the smooth copy. A batch that
    pinning does not close fails the run: a fault of the port, with the
    saved batch as its witness. Returns the probe's readings, or None."""
    import torch

    if all(d <= GRAD_TOL for d in dist.values()):
        return None
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rl_loop_batch_{time.strftime('%Y%m%dT%H%M%S')}.pt")
    torch.save(batch, path)
    print(f"{what}: unpinned gradient {json.dumps(dist)} above GRAD_TOL {GRAD_TOL}; the batch saved to {path}; "
          f"held by the probe at GAP_TOL {GAP_TOL} instead")
    res = rl_gap(device, batch, loss_fn, what, held=True)
    return {"unpinned": dist, "batch": path, "pinned": res["k"]["pinned"],
            "smooth_pallas_vs_xla": res["k"]["smooth_pallas_vs_xla"],
            "flips": {name: sum(v[0] for v in c["flips"].values()) for name, c in res["k"]["census"].items()},
            "flipped_sites": {name: sorted(c["flips"]) for name, c in res["k"]["census"].items()}}


# ------------------------------------------------------------------ replay
REPLAY_ITERS = 2  # the replay loop's learner: RL_B x RL_T batches from the store (4 until the sc2 phase came, 8 until
# the health drill, 6 until the diagnostics)
REPLAY_SPI = 4.0  # --replay-spi: each trajectory sampled about four times
REPLAY_SMALL_ITERS = 2  # the smaller runs: smoke model, 2 x 4 batches
# the 2-shard run: the ring sends each insert to a shard by the hash of a
# random key, so both take some with probability 1 - 2^(1 - inserts); 8
# steps draw about 10 inserts at spi 2 (a 4-step run once sent all 4 to one)
REPLAY_SHARDS_ITERS = 8
REPLAY_SMALL = ("--env-num", "2", "--traj-len", "4", "--batch-size", "2", "--episode-game-loops", "60")
REMOTE_SL_ITERS = 4  # bin/sl_train.py --remote: 4 steps of 2 x 8
# the store's shared-memory rings: a flagship trajectory pickles to about
# 7 MB and a sample reply carries RL_B of them, past the 4 MiB default
REPLAY_RING_BYTES = 48 << 20
PLAY_GAMES = 2


def traj_digest(traj):
    """sha256 over a trajectory's leaves (path, dtype, shape, bytes): equal
    digests are equal trees, bit for bit."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        else:
            a = np.asarray(x)
            h.update(f"{path}|{a.dtype.str}|{a.shape}|".encode())
            h.update(np.ascontiguousarray(a).tobytes() if a.dtype != object else repr(x).encode())

    walk(traj, "")
    return h.hexdigest()


def counter_delta(prefix, before):
    from distar_tpu_torch.obs import get_registry

    return sum(v for k, v in get_registry().snapshot().items() if k.startswith(prefix)) - before


def limiter_holds(state, what):
    """The samples-per-insert invariant of a table's ``RateLimiter.state()``:
    past ``min_size`` inserts, ``spi * (inserts - min_size)`` within
    ``error_buffer`` of the samples on either side."""
    spi, eb = state["samples_per_insert"], state["error_buffer"]
    if spi is None:
        return
    adj = max(state["inserts"] - state["min_size_to_sample"], 0)
    check(state["samples"] <= spi * adj + eb and spi * adj <= state["samples"] + eb,
          f"{what}: the limiter let the ratio out of its buffer: {state}")


def replay_processes(tmp, smi, device):
    """``bin/rl_train.py`` roles as processes on the smoke model: coordinator,
    league, ``--type replay`` on a spill directory and an actor on
    ``--replay-addr``; once the limiter parks the actor (fifo, spi 1, a
    batch of 2: four inserts acknowledged and unsampled) the store is
    SIGKILLed and started again on its port and directory, and must recover
    the four; a learner on ``--replay-addr`` then trains 2 steps (exit 0,
    ``learner done``), and SIGTERM ends the actor, the store, the
    coordinator and the league with exit 0."""
    import signal
    import urllib.request

    cfg = json.dumps({"league": LOOP_LEAGUE})
    spill, port = os.path.join(tmp, "replay_role_spill"), free_port()
    procs, logs, out = {}, {}, {}
    dev = ("--device", device.type)

    def start(name, role, *flags):
        logs[name] = os.path.join(tmp, f"replay_{name}.log")
        with open(logs[name], "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.bin.rl_train", "--type", role, *dev, *flags],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)

    def line(name, prefix, timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for ln in open(logs[name]).read().splitlines():
                if ln.startswith(prefix):
                    return ln
            check(procs[name].poll() is None, f"replay {name} exited: {open(logs[name]).read()[-2000:]}")
            time.sleep(0.1)
        raise SmokeFailure(f"replay {name}: no line '{prefix}' in {timeout} s")

    def stats(admin):
        with urllib.request.urlopen(f"{admin}/replay/stats", timeout=10) as resp:
            return json.loads(resp.read())

    store_flags = ("--port", str(port), "--replay-spill-dir", spill, "--metrics-port", "0", "--batch-size", "2")
    sizes = REPLAY_SMALL
    t0 = time.perf_counter()
    try:
        start("coordinator", "coordinator", "--port", "0")
        start("league", "league", "--port", "0", "--config", cfg)
        start("store", "replay", *store_flags)
        co = line("coordinator", "coordinator serving on ").rsplit(" ", 1)[1]
        lg = line("league", "league serving on ").rsplit(" ", 1)[1]
        admin = line("store", "replay admin on ").split()[-1].rsplit("/replay/stats", 1)[0]
        line("store", "replay store serving on ")
        replay = ("--replay-addr", f"127.0.0.1:{port}")
        start("actor", "actor", "--coordinator-addr", co, "--league-addr", lg, *replay, *sizes)
        deadline = time.time() + 300
        while True:
            st = stats(admin)
            lim = st.get("tables", {}).get("MP0", {}).get("limiter", {})
            if lim.get("inserts", 0) >= 4 and not lim.get("can_insert", True):
                break
            check(time.time() < deadline and procs["actor"].poll() is None,
                  f"replay actor never filled the store: {open(logs['actor']).read()[-2000:]}")
            time.sleep(0.2)
        acked = st["tables"]["MP0"]["size"]
        check(acked == lim["inserts"] == 4 and lim["samples"] == 0 and st["spill"]["live"] == 4,
              f"replay store before the kill: {st}")
        out["transports_before_kill"] = st.get("transports")
        procs["store"].kill()
        procs["store"].wait(timeout=30)
        t1 = time.perf_counter()
        start("store2", "replay", *store_flags)
        # the learner starts with the restart: its client dials through the
        # store's absence under its retry policy
        start("learner", "learner", "--coordinator-addr", co, "--league-addr", lg, *replay, "--iters", "2",
              "--save-path", os.path.join(tmp, "replay_learner"), *sizes)
        recovered = line("store2", f"replay shard :{port}: recovered ")
        line("store2", "replay store serving on ")
        out["restart_to_serving_s"] = time.perf_counter() - t1
        check(f"recovered {acked} acked trajectories" in recovered,
              f"replay restart: '{recovered}', want {acked} recovered")
        out["recovered"] = acked
        wait_ok(procs["learner"], logs["learner"], "replay learner process", timeout=300)
        check("learner done: 2 iters" in open(logs["learner"]).read(), "replay learner: no done line")
        out["learner_done_s"] = time.perf_counter() - t1
        names = ("actor", "store2", "coordinator", "league")
        for name in names:
            check(procs[name].poll() is None, f"replay {name} exited early: {open(logs[name]).read()[-2000:]}")
            procs[name].send_signal(signal.SIGTERM)
        for name in names:
            rc = procs[name].wait(timeout=60)
            text = open(logs[name]).read()
            check(rc == 0 and (name not in ("actor", "store2") or "Traceback" not in text),
                  f"replay {name} after SIGTERM: rc {rc} {text[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.perf_counter() - t0
    print(f"replay processes ({smi}): coordinator, league, --type replay (spill; SIGKILL with 4 acknowledged, "
          f"unsampled inserts; restarted on its port and directory), actor and learner on --replay-addr "
          f"(2 steps, exit 0), SIGTERM exit 0 each: {json.dumps(out)}")
    return out


def replay_small_runs(device, tmp):
    """``bin/rl_train.py --type all --replay`` on the smoke model in the two
    other layouts: ``--replay-shards 2`` (each shard takes inserts, their
    sum the actor's acknowledged pushes) and ``--replay-fast-path`` (no
    server; the same count). Runs beside other work, in a process of its
    own in the whole script, so it reads what the runs return, not what
    they print."""
    from distar_tpu_torch.bin import rl_train

    out = {}
    for name, iters, flags in (("shards_2", REPLAY_SHARDS_ITERS, ("--replay-shards", "2")),
                               ("fast_path", REPLAY_SMALL_ITERS, ("--replay-fast-path",))):
        pushed0 = counter_delta("distar_actor_replay_pushed_total", 0.0)
        t0 = time.perf_counter()
        # --no-health: a process holds one fleet health, and these runs share
        # this one with each other and the phases (ROADMAP Queue 3 item 31)
        loop = rl_train.main(["--type", "all", "--replay", "--replay-sampler", "uniform", "--replay-spi", "2",
                              "--no-health", "--device", device.type, "--iters", str(iters),
                              "--save-path", os.path.join(tmp, f"replay_{name}"), *REPLAY_SMALL, *flags])
        seconds = time.perf_counter() - t0
        check(loop.learner.last_iter.val == iters and finite(loop.learner.last_log),
              f"replay {name}: {loop.learner.last_iter.val} iterations, {loop.learner.last_log}")
        pushed = counter_delta("distar_actor_replay_pushed_total", pushed0)
        per = [s.table("MP0").limiter.state() if "MP0" in s.tables() else {"inserts": 0, "samples": 0}
               for s in loop.replay_stores]
        inserts = [st["inserts"] for st in per]
        check(sum(inserts) == pushed > 0, f"replay {name}: store inserts {inserts}, acknowledged pushes {pushed}")
        check(sum(st["samples"] for st in per) >= iters * 2, f"replay {name}: samples {per}")
        if name == "shards_2":
            check(len(per) == 2 and min(inserts) > 0 and len(loop.replay_servers) == 2,
                  f"replay shards: inserts per shard {inserts}")
        else:
            check(not loop.replay_servers and len(per) == 1, "replay fast path: a server was started")
        out[name] = {"seconds": seconds, "inserts": inserts, "samples": [st["samples"] for st in per],
                     "acked_pushes": pushed}
        del loop
    print(f"replay smaller runs (smoke model, batches of 2 x 4; 2 shards {REPLAY_SHARDS_ITERS} steps, the fast "
          f"path {REPLAY_SMALL_ITERS}): {json.dumps(out)}")
    return out


def remote_sl_and_play(device, tmp):
    """``bin/sl_train.py --remote`` on a coordinator that an in-script
    ``ReplayActor`` feeds through a stub decoder (SL steps of
    ``fake_sl_batch``, 16 a trajectory), REMOTE_SL_ITERS steps of 2 x 8;
    then ``bin/play.py --game_type mock`` for PLAY_GAMES games. Runs beside
    other work, so it reads what the entry points return."""
    import numpy as np

    from distar_tpu_torch.bin import play, sl_train
    from distar_tpu_torch.comm import Adapter, CoordinatorServer
    from distar_tpu_torch.learner.data import fake_sl_batch
    from distar_tpu_torch.learner.replay_actor import RemoteSLDataloader, ReplayActor
    from distar_tpu_torch.learner.sl_dataloader import batch_steps

    class StubDecoder:
        def __init__(self):
            self.rng = np.random.default_rng(10)

        def run(self, path, player_idx):
            return batch_steps(fake_sl_batch(1, 16, rng=self.rng), 16)

    out = {}
    co = CoordinatorServer()
    co.start()
    try:
        addr = (co.host, co.port)
        # 2 x 8 a step: REMOTE_SL_ITERS + 2 (the prefetch depth) batches of two 8-step windows
        actor = ReplayActor([f"r{i}.SC2Replay" for i in range(3)],
                            adapter_factory=lambda: Adapter(coordinator_addr=addr),
                            decoder_factory=StubDecoder, ntasks=1, proc_id=0)
        t0 = time.perf_counter()
        actor.run()
        out["replay_actor_s"] = time.perf_counter() - t0
        check(actor.pushed == 6 and actor.failed == 0, f"replay actor pushed {actor.pushed}, failed {actor.failed}")
        t0 = time.perf_counter()
        lrn = sl_train.main(["--remote", "--coordinator-addr", f"{co.host}:{co.port}", "--no-health",
                             "--device", device.type,
                             "--iters", str(REMOTE_SL_ITERS), "--batch-size", "2", "--traj-len", "8",
                             "--no-supervise", "--save-path", os.path.join(tmp, "remote_sl")])
        out["sl_train_s"] = time.perf_counter() - t0
        check(lrn.last_iter.val == REMOTE_SL_ITERS, f"sl_train --remote: {lrn.last_iter.val} iterations")
        source = getattr(lrn._dataloader, "source", lrn._dataloader)
        check(isinstance(source, RemoteSLDataloader), f"sl_train --remote trained on {type(source).__name__}")
        check(finite(lrn.last_log), f"sl_train --remote: {lrn.last_log}")
        out["sl_loss"] = lrn.last_log["total_loss"]
    finally:
        co.stop()
    t0 = time.perf_counter()
    results = play.main(["--game_type", "mock", "--device", device.type, "--game-count", str(PLAY_GAMES),
                         "--episode-game-loops", "60"])
    out["play_s"] = time.perf_counter() - t0
    check(len(results) == PLAY_GAMES and all(r[s]["winloss"] in (-1, 0, 1) for r in results for s in ("0", "1")),
          f"play: {results}")
    out["play_winloss"] = [r["0"]["winloss"] for r in results]
    print(f"replay: bin/sl_train.py --remote ({REMOTE_SL_ITERS} steps of 2 x 8 from a ReplayActor's 6 "
          f"trajectories) and bin/play.py --game_type mock ({PLAY_GAMES} games): {json.dumps(out)}")
    return out


def path_kernels_against_plain(K, captured, what="replay"):
    """Each kernel's wrapper on one call's inputs captured from each side of
    a loop (the replay loop's actor flush and learner step; an Anakin window
    and its learner step), held against its plain version: attention within
    ATTN_TOL, the scatter bit-equal to ``scatter_add_plain``. Returns the max
    abs error per kernel and the shapes."""
    import torch

    errs, shapes = {}, {}
    for (side, name), args in sorted(captured.items()):
        if name == "masked_attention":
            err = attention_check(K, f"{what} {side}", *args)
        else:
            emb, idx, hw = args
            got, want = K.scatter_add_connection(emb, idx, hw), K.scatter_add_plain(emb, idx, hw)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{what} {side}: scatter_add_connection differs from scatter_add_plain")
            err = float((got - want).abs().max())
        errs[name] = max(errs.get(name, 0.0), err)
        shapes[f"{side} {name}"] = list(args[0].shape)
    print(f"{what}: the path's kernels on inputs captured from each side, against their plain versions: "
          f"max abs err {json.dumps(errs)}, shapes {json.dumps(shapes)}")
    return errs


def replay_recovery(args, store, spill_dir, mp):
    """A new store on the loop's spill directory: what it recovers is what
    the loop's store holds acknowledged and unsampled (the spill's live
    blobs). Returns (count, seconds)."""
    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.replay import ReplayStore, SpillRing

    live = store._spill.live_count()
    unsampled = sum(1 for it in store.table(mp)._items.values() if it.sample_count == 0)
    t0 = time.perf_counter()
    back = ReplayStore(table_factory=lambda name: rl_train._table_config(args), spill=SpillRing(spill_dir),
                       recover_encoded=True)
    recovered = back.recover()
    seconds = time.perf_counter() - t0
    check(recovered == live == unsampled, f"replay: recovered {recovered}, spill live {live}, unsampled {unsampled}")
    return recovered, seconds


def replay_smoke_runs(device, tmp):
    """The replay phase's runs on the smoke model in process: the other two
    layouts, then ``sl_train --remote`` and ``play.py``."""
    return replay_small_runs(device, tmp), remote_sl_and_play(device, tmp)


def phase_replay(device, smi, tmp, rl_loop, background=None):
    """The replay store between actors and learner (module docstring,
    phase 11). ``background``: its ``replay_processes`` and
    ``replay_smoke_runs`` as ``Background`` and ``Spawned`` jobs, started
    beside phase 9's first parts (``main``), else started here; either way
    they end before this phase's loop, which they would disturb. Returns the launch counts
    of its flagship loop (actor and learner) and the measurements."""
    import shutil
    import threading

    import torch

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.comm.serializer import dumps
    from distar_tpu_torch.learner.data import as_float32
    from distar_tpu_torch.learner.rl_dataloader import ReplayDataLoader
    from distar_tpu_torch.ops import build
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.replay import SampleClient

    t_phase = time.perf_counter()
    jobs = background or [Background(lambda: replay_processes(tmp, smi, device)),
                          Spawned(replay_smoke_runs, device, tmp, tmp=tmp)]
    for job in jobs:
        if not job.started:
            job.start()
    roles, (small, remote) = (job.result() for job in jobs)
    waited_s = time.perf_counter() - t_phase
    spill_dir = os.path.join(tmp, "replay_spill")
    args = rl_train.parser().parse_args([
        "--type", "all", "--full-model", "--iters", str(REPLAY_ITERS), "--batch-size", str(RL_B),
        "--traj-len", str(RL_T), "--env-num", str(LOOP_ENV_NUM), "--episode-game-loops", str(LOOP_EPISODE_LOOPS),
        "--save-path", os.path.join(tmp, "replay_loop"), "--device", device.type, "--replay",
        "--replay-sampler", "uniform", "--replay-spi", str(REPLAY_SPI), "--replay-spill-dir", spill_dir,
        "--config", json.dumps({"model": overlay("pallas", "pallas"), "league": LOOP_LEAGUE,
                                "learner": {"log_freq": 1}})])
    rl_train._resolve_args(args)
    loop = rl_train.build_all(args)
    actor, learner = loop.actor, loop.learner
    server, = loop.replay_servers
    store = server.store
    mp = loop.player_id
    eb = max(REPLAY_SPI, 1.0) * RL_B
    try:
        shm_free = shutil.disk_usage("/dev/shm").free
    except OSError:
        shm_free = 0
    if shm_free >= 5 * REPLAY_RING_BYTES:  # two connections, a ring each way
        server.ring_bytes = REPLAY_RING_BYTES
    print(f"replay: /dev/shm free {shm_free} bytes, the store's rings {server.ring_bytes} bytes")
    print(f"replay: --type all --replay, one ReplayServer on {server.host}:{server.port} (transport auto), "
          f"sampler uniform, spi {REPLAY_SPI}, error_buffer {eb}, min size {RL_B}, spill on; actor on "
          f"{LOOP_ENV_NUM} MockEnv({LOOP_EPISODE_LOOPS}), learner {RL_B} x {RL_T} x {REPLAY_ITERS}, prefetch "
          f"depth {learner.cfg.learner.get('prefetch_depth', 2)}, kernel overlay, f32")

    # instruments, outside the port: the actor's inserts (ms, a digest each),
    # the learner's samples (ms, each item's digest looked up), the spill's
    # appends, the flushes and steps, each kernel's first call per side
    digests, inserts, samples, spill_ms, flush_ms, steps = set(), [], [], [], [], []
    problems, captured, sizes = [], {}, {}
    client = actor._get_replay_client()
    real = {"insert": client.insert, "append": store._spill.append, "sample": BatchedInference.sample,
            "attention": K.masked_attention, "scatter": K.scatter_add_connection}

    def insert(table, traj, **kw):
        digests.add(traj_digest(traj))  # before the store can serve it
        if "pickle_bytes" not in sizes:
            sizes["pickle_bytes"] = len(dumps(traj, compress=False))
        t0 = time.perf_counter()
        seq = real["insert"](table, traj, **kw)
        inserts.append((time.perf_counter() - t0) * 1e3)
        limiter_holds(store.table(mp).limiter.state(), "replay insert")
        return seq

    def append(key, table, item, priority):
        t0 = time.perf_counter()
        real["append"](key, table, item, priority)
        spill_ms.append((time.perf_counter() - t0) * 1e3)
        sizes.setdefault("spill_blob_bytes", os.path.getsize(store._spill._path(key)))

    def sample_flush(self, prepared, active=None, noise=None):
        t0 = time.perf_counter()
        out = real["sample"](self, prepared, active, noise)
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def side():
        return "learner" if threading.current_thread() is threading.main_thread() else "actor"

    def attention(q, k, v, mask):
        key = (side(), "masked_attention")
        if key not in captured:
            captured[key] = [t.detach().clone() for t in (q, k, v, mask)]
        return real["attention"](q, k, v, mask)

    def scatter(emb, idx, hw):
        key = (side(), "scatter_add_connection")
        if key not in captured:
            captured[key] = (emb.detach().clone(), idx.clone(), hw)
        return real["scatter"](emb, idx, hw)

    sampler = learner._dataloader._client
    check(isinstance(sampler, SampleClient) and isinstance(learner._dataloader, ReplayDataLoader),
          "replay: the learner does not sample the store")

    def sample(table, batch_size=1, timeout_s=None):
        t0 = time.perf_counter()
        items, info = real_sample(table, batch_size=batch_size, timeout_s=timeout_s)
        samples.append((time.perf_counter() - t0) * 1e3)
        missing = [d["seq"] for it, d in zip(items, info) if traj_digest(it) not in digests]
        if missing:
            problems.append(f"sampled seqs {missing} match no pushed trajectory")
        limiter_holds(store.table(mp).limiter.state(), "replay sample")
        return items, info

    real_sample = sampler.sample
    sampler.sample = sample
    client.insert, store._spill.append = insert, append
    below = TimedBatches(learner._dataloader)  # the source: sampling and collation
    learner.set_dataloader(below)
    above = time_prefetched(learner)
    real_train = learner._train

    def train(data):
        t0 = time.perf_counter()
        log = real_train(data)
        steps.append(((time.perf_counter() - t0) * 1e3, log))
        return log

    learner._train = train
    counts = ThreadCounts(build.KERNELS)
    real_counts, K.launch_counts = K.launch_counts, counts
    BatchedInference.sample = sample_flush
    K.masked_attention, K.scatter_add_connection = attention, scatter
    pushed0 = counter_delta("distar_actor_replay_pushed_total", 0.0)
    dropped0 = counter_delta("distar_actor_replay_push_failures_total", 0.0)
    fallbacks0 = counter_delta("distar_shm_fallbacks_total", 0.0)
    try:
        K.reset_launch_counts()
        counts.by_side = {s: {n: 0 for n in build.KERNELS} for s in ("learner", "actor")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop.supervisor.start()
        rl_train._run_learner_supervised(args, learner, REPLAY_ITERS)
        loop_s = time.perf_counter() - t0
        launches = {"learner": dict(counts.by_side["learner"]), "actor": dict(counts.by_side["actor"])}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        state_loop = store.table(mp).limiter.state()  # before the close stops the pacing
        transports = (client.transport_active, sampler.transport_active)
        batch = below.first
        K.masked_attention, K.scatter_add_connection = real["attention"], real["scatter"]
        in_loop_profile = profile_call(lambda: real_train(batch))  # the actor still running
    finally:
        try:
            rl_train.close_all(loop)  # the actor's job ends with its pushes timed
        finally:
            K.launch_counts = real_counts
            K.masked_attention, K.scatter_add_connection = real["attention"], real["scatter"]
            BatchedInference.sample = real["sample"]
            learner._train = real_train
            client.insert, store._spill.append, sampler.sample = real["insert"], real["append"], real_sample

    # what the loop did; after the close the actor's job has ended, so every
    # insert is acknowledged, and the prefetcher sampled at most its depth,
    # the batch it was placing and the one it was sampling ahead
    state = store.table(mp).limiter.state()
    acked = counter_delta("distar_actor_replay_pushed_total", pushed0)
    depth = int(learner.cfg.learner.get("prefetch_depth", 2))
    consumed = REPLAY_ITERS * RL_B
    check(not problems, f"replay: {problems[:3]}")
    check(learner.last_iter.val == REPLAY_ITERS and len(steps) == REPLAY_ITERS,
          f"replay: {learner.last_iter.val} iterations, {len(steps)} steps")
    check(all(finite(lg) for _, lg in steps), "replay: a non-finite loss or grad_norm")
    check(counter_delta("distar_actor_replay_push_failures_total", dropped0) == 0, "replay: the actor dropped pushes")
    check(state["inserts"] == acked == len(inserts) > 0,
          f"replay: store inserts {state['inserts']}, the actor's acknowledged pushes {acked} ({len(inserts)} timed)")
    check(state["samples"] % RL_B == 0 and consumed <= state["samples"] <= consumed + (depth + 2) * RL_B,
          f"replay: store samples {state['samples']}, the learner consumed {consumed}, prefetch depth {depth}")
    limiter_holds(state_loop, "replay at the learner's end")
    fallbacks = counter_delta("distar_shm_fallbacks_total", fallbacks0)
    if server.ring_bytes == REPLAY_RING_BYTES:
        check(transports == ("shm", "shm") and fallbacks == 0,
              f"replay: transports {transports}, {fallbacks} shm fallbacks, want shm on one host")
    for s in ("learner", "actor"):
        for name in ("masked_attention", "scatter_add_connection"):
            check(launches[s][name] > 0, f"replay: {name} never launched on the {s}'s side")
    held = as_float32({k: v for k, v in batch.items() if k not in ("trace_span_ids", "trace_age_s")})
    step_alone, _ = step_times({"pallas": learner}, held, rounds=3, warmup=1)
    del learner, loop

    errs = path_kernels_against_plain(K, captured)
    del captured
    recovered, recover_s = replay_recovery(args, store, spill_dir, mp)
    logs = steps_agree("replay: one RL step on a store-sampled batch", OneLearner(rl_learner(device), fresh=True),
                       held)

    wait = above["it"].wait_ms
    result = {
        "seconds": time.perf_counter() - t_phase, "waited_for_background_s": waited_s, "loop_s": loop_s,
        "inserts": state["inserts"], "samples": state["samples"], "consumed": consumed,
        "reuse": state["samples"] / state["inserts"], "reuse_consumed": consumed / state["inserts"],
        "spi": REPLAY_SPI, "limiter_at_learner_end": state_loop, "transports": transports,
        "shm_fallbacks": fallbacks, "ring_bytes": server.ring_bytes,
        "frames_made_per_s": state["inserts"] * RL_T / loop_s,
        "frames_consumed_per_s": REPLAY_ITERS * RL_B * RL_T / loop_s,
        "data_wait_ms": {"learner_median": statistics.median(wait), "learner_min": min(wait),
                         "learner_max": max(wait), "source_median": statistics.median(below.wait_ms),
                         "source_all": below.wait_ms,
                         "rl_loop_learner": rl_loop["data_wait_ms"]["learner_median"],
                         "rl_loop_learner_min": min(rl_loop["data_wait_ms"]["learner_all"]),
                         "rl_loop_learner_max": max(rl_loop["data_wait_ms"]["learner_all"]),
                         "rl_loop_source_median": rl_loop["data_wait_ms"]["median"]},
        "step_ms": {"loop_median": statistics.median(ms for ms, _ in steps), "loop_all": [ms for ms, _ in steps],
                    "alone_median": step_alone["pallas"]},
        "flush_ms": {"loop_median": statistics.median(flush_ms), "loop_n": len(flush_ms),
                     "alone_median": rl_loop["flush_ms"]["alone_median"]},
        "insert_ms": {"median": statistics.median(inserts), "max": max(inserts)},
        "sample_ms": {"median": statistics.median(samples), "max": max(samples)},
        "spill_append_ms": {"median": statistics.median(spill_ms), "max": max(spill_ms)},
        "bytes": sizes, "recovery": {"count": recovered, "seconds": recover_s},
        "peak_memory_gb": peak_gb, "in_loop_step_profile": in_loop_profile,
        "losses": [lg["total_loss"] for _, lg in steps], "launches": launches,
        "kernel_max_abs_err": errs, "strings_total_loss": {k: lg["total_loss"] for k, lg in logs.items()},
        "processes": roles, "smaller_runs": small, "remote_sl_and_play": remote,
    }
    print(f"replay ({smi}): " + json.dumps({k: v for k, v in result.items() if k != "in_loop_step_profile"}))
    print(f"replay: a learner step profiled inside the loop (the actor running): {json.dumps(in_loop_profile)}")
    total = {n: launches["learner"][n] + launches["actor"][n] for n in build.KERNELS}
    return total, result


# ------------------------------------------------------------------ anakin
ANAKIN_B, ANAKIN_T = 16, 16  # lanes x steps a window: 256 acted frames a learner step (272 observed)
ANAKIN_ITERS = 3
ANAKIN_UNITS, ANAKIN_EPISODE_LEN = 4, 32  # the JAX launcher's --jaxenv-units / --jaxenv-episode-len
H2H_EPISODES = 16
JAXENV_ITERS = 2  # --type all --env jaxenv on the smoke model


def jaxenv_smoke_run(device, tmp):
    """``bin/rl_train.py --type all --env jaxenv`` on the smoke model: the
    actor on the micro-battle world's host env (on the card), the learner
    on its trajectories, JAXENV_ITERS iterations. Runs beside other work,
    in a process of its own in the whole script, so it reads what the run
    returns, not what it prints."""
    from distar_tpu_torch.bin import rl_train

    t0 = time.perf_counter()
    loop = rl_train.main(["--type", "all", "--env", "jaxenv", "--smoke-model", "--no-health", "--device", device.type,
                          "--iters", str(JAXENV_ITERS), "--env-num", "2", "--traj-len", "4", "--batch-size", "2",
                          "--jaxenv-episode-len", "8", "--save-path", os.path.join(tmp, "jaxenv_all")])
    seconds = time.perf_counter() - t0
    lrn = loop.learner
    check(lrn.last_iter.val == JAXENV_ITERS and finite(lrn.last_log),
          f"--env jaxenv: {lrn.last_iter.val} iterations, {lrn.last_log}")
    out = {"seconds": seconds, "iters": lrn.last_iter.val, "total_loss": lrn.last_log["total_loss"],
           "games": loop.league.all_players[loop.player_id].total_game_count}
    print(f"anakin: bin/rl_train.py --type all --env jaxenv (smoke model, {JAXENV_ITERS} iterations): "
          f"{json.dumps(out)}")
    return out


def flat_shapes(tree, prefix=""):
    """{path: shape} of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tuple(tree.shape)}
    return {k: v for key, sub in items for k, v in flat_shapes(sub, f"{prefix}/{key}").items()}


def phase_anakin(device, smi, tmp):
    """The Anakin loop at the flagship (module docstring, phase 12).
    Returns the launch counts of its path (the windows' and the learner
    steps') and the measurements."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.envs.jaxenv import (AnakinDataLoader, AnakinRunner, attack_nearest_policy,
                                              head_to_head, idle_policy, model_policy, observe)
    from distar_tpu_torch.ops import build
    from distar_tpu_torch.ops import kernels as K

    t_phase = time.perf_counter()
    args = rl_train.parser().parse_args([
        "--anakin", "--env", "jaxenv", "--full-model", "--iters", str(ANAKIN_ITERS),
        "--batch-size", str(ANAKIN_B), "--traj-len", str(ANAKIN_T), "--jaxenv-units", str(ANAKIN_UNITS),
        "--jaxenv-episode-len", str(ANAKIN_EPISODE_LEN), "--save-path", os.path.join(tmp, "anakin"),
        "--device", device.type, "--config", json.dumps({"model": overlay("pallas", "pallas"),
                                                          "learner": {"log_freq": 1}})])
    rl_train._resolve_args(args)
    t0 = time.perf_counter()
    learner, loader, first = rl_train.build_anakin(args)  # its first window under the purity report
    build_s = time.perf_counter() - t0
    check(first == {"pure": True, "offending": []}, f"anakin: the first window is not device-pure: {first}")
    runner = loader.runner
    jcfg, scfg = runner.env_cfg, runner.gen.cfg
    layers = int(learner.model_cfg.encoder.entity.layer_num)
    n_params = sum(p.numel() for p in learner.model.parameters())
    print(f"anakin: bin/rl_train.py --anakin --env jaxenv, the flagship with value towers ({n_params} "
          f"parameters), kernel overlay, f32; {ANAKIN_B} lanes x {ANAKIN_T} steps, {ANAKIN_UNITS} units a "
          f"squad, episodes of {ANAKIN_EPISODE_LEN} steps; {ANAKIN_ITERS} learner iterations, no prefetch")

    # instruments, outside the port: each window's and each step's time and
    # launches, each kernel's first call in a window and in a step
    side, windows, steps, captured = {"now": None}, [], [], {}
    real = {"train": learner._train, "attention": K.masked_attention, "scatter": K.scatter_add_connection}

    class Windows:
        def __iter__(self):
            return self

        def __next__(self):
            before = dict(K.launch_counts)
            side["now"] = "window"
            t0 = time.perf_counter()
            batch = next(loader)  # it reads done back after the window: the device has finished
            windows.append((time.perf_counter() - t0, {n: K.launch_counts[n] - before[n] for n in build.KERNELS}))
            side["now"] = None
            return batch

    def train(data):
        before = dict(K.launch_counts)
        side["now"] = "learner step"
        t0 = time.perf_counter()
        log = real["train"](data)  # ends in the copy of its scalars to the host
        steps.append(((time.perf_counter() - t0) * 1e3, log, {n: K.launch_counts[n] - before[n]
                                                               for n in build.KERNELS}))
        side["now"] = None
        return log

    def attention(q, k, v, mask):
        key = (side["now"], "masked_attention")
        if side["now"] and key not in captured:
            captured[key] = [t.detach().clone() for t in (q, k, v, mask)]
        return real["attention"](q, k, v, mask)

    def scatter(emb, idx, hw):
        key = (side["now"], "scatter_add_connection")
        if side["now"] and key not in captured:
            captured[key] = (emb.detach().clone(), idx.clone(), hw)
        return real["scatter"](emb, idx, hw)

    counts = ThreadCounts(build.KERNELS)
    real_counts, K.launch_counts = K.launch_counts, counts
    learner.set_dataloader(Windows())
    learner._train = train
    K.masked_attention, K.scatter_add_connection = attention, scatter
    try:
        K.reset_launch_counts()
        counts.by_side = {s: {n: 0 for n in build.KERNELS} for s in ("learner", "actor")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rl_train._run_learner_supervised(args, learner, ANAKIN_ITERS)
        run_s = time.perf_counter() - t0
        launches = dict(counts)
        other_threads = dict(counts.by_side["actor"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        K.launch_counts = real_counts
        K.masked_attention, K.scatter_add_connection = real["attention"], real["scatter"]
        learner._train = real["train"]
    check(learner.last_iter.val == ANAKIN_ITERS and len(steps) == ANAKIN_ITERS == len(windows),
          f"anakin: {learner.last_iter.val} iterations, {len(steps)} steps, {len(windows)} windows")
    check(all(finite(lg) for _, lg, _ in steps), "anakin: a non-finite loss or grad_norm")
    check(not any(other_threads.values()), f"anakin: launches from another thread {other_threads}")
    want_window = {"masked_attention": layers * ANAKIN_T, "scatter_add_connection": ANAKIN_T, "scatter_add_onehot": 0}
    want_step = {"masked_attention": layers, "scatter_add_connection": 1, "scatter_add_onehot": 0}
    check(all(n == want_window for _, n in windows), f"anakin: launches per window {[n for _, n in windows]}, "
          f"want {want_window}")
    check(all(n == want_step for _, _, n in steps), f"anakin: launches per learner step {[n for _, _, n in steps]}")

    # a steady-state window: no synchronizing call (sync debug mode
    # "error") and no host<->device copy (the profiler, device activities
    # only) inside it; the one deliberate read (the finished lanes) after it
    carry = mid = loader._carry
    torch.cuda.synchronize()
    t_sub = {"run": run_s}
    t1 = time.perf_counter()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, batch = runner.rollout(learner.model, carry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    pure_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    acts = device_activities(prof)
    t_sub["steady_window"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    memcpy = {k: v for k, v in acts.items() if "Memcpy" in k and ("HtoD" in k or "DtoH" in k)}
    check(not memcpy, f"anakin: host<->device copies inside a steady-state window: {memcpy}")
    busy = sum(ms for ms, _ in acts.values())
    ended = int(batch["done"][-1].sum())
    loader._carry = carry
    window_profile = {"wall_ms": pure_ms, "device_busy_ms": busy, "idle_share": 1 - busy / pure_ms,
                      "device_activities": sum(n for _, n in acts.values()), "memcpy_htod_dtoh": 0,
                      "lanes_finished": ended,
                      "top": [{"name": k[:80], "ms": ms, "count": n}
                              for k, (ms, n) in sorted(acts.items(), key=lambda kv: -kv[1][0])[:8]]}

    # one forward at the window's width alone, beside rl_loop's 8-lane flush
    obs = observe(jcfg, carry[0], 0)
    fwd_ms = []
    with torch.no_grad():
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner._sample(learner.model, obs, carry[1], None)
            torch.cuda.synchronize()
            if i:
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
    t_sub["forward_alone"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    step_profile = profile_call(lambda: learner._train(batch))
    t_sub["step_profile"] = time.perf_counter() - t1
    layout = flat_shapes(batch)

    # the away seat: a frozen copy of the initial policy on the away team,
    # one window from the lanes the steady window began from, most of them
    # halfway through their episodes: those episodes end in it
    opp_runner = AnakinRunner(learner.model, ANAKIN_B, ANAKIN_T, jcfg, scfg, seed=1, opponent_seat=True,
                              device=device)
    opp = AnakinDataLoader(opp_runner, model_provider=lambda: learner.model)
    opp._carry = (mid[0], mid[1], opp_runner._zero_hidden())
    ending = int(((~mid[0].done) & (mid[0].t + ANAKIN_T >= ANAKIN_EPISODE_LEN)).sum())
    t0 = time.perf_counter()
    opp_batch = next(opp)
    opp_s = time.perf_counter() - t0
    results = opp.drain_results()
    check(flat_shapes(opp_batch) == layout, "anakin: the away-seat batch has another layout")
    check(ending > 0 and len(results) >= ending and {r["winner"] for r in results} <= {"home", "away", "draw"}
          and opp.drain_results() == [], f"anakin: away-seat results {results[:4]} ({len(results)}, "
          f"{ending} lanes due to end)")
    tally = {w: sum(r["winner"] == w for r in results) for w in ("home", "away", "draw")}
    del opp, opp_runner, opp_batch

    # win rates: the flagship policy against the scripted attacker, and the
    # scripted attacker against the idle one
    h2h = {}
    for name, (a, b) in {"model_vs_attack_nearest": (model_policy(learner.model), attack_nearest_policy()),
                         "attack_nearest_vs_idle": (attack_nearest_policy(), idle_policy())}.items():
        t0 = time.perf_counter()
        res = head_to_head(a, b, episodes=H2H_EPISODES, seed=0, env_cfg=jcfg, scenario_cfg=scfg, device=device)
        seconds = time.perf_counter() - t0
        check(set(res) == {"win_rate", "wins", "losses", "draws", "episodes", "matches", "mean_game_steps",
                           "duration_s"} and res["episodes"] == len(res["matches"]) == H2H_EPISODES
              and res["wins"] + res["losses"] + res["draws"] == H2H_EPISODES, f"anakin: head-to-head {res}")
        h2h[name] = {"seconds": seconds, **{k: v for k, v in res.items() if k != "matches"}}

    t1 = time.perf_counter()
    errs = path_kernels_against_plain(K, captured, "anakin")
    t_sub["kernels_vs_plain"] = time.perf_counter() - t1
    check(set(captured) == {(s, n) for s in ("window", "learner step")
                            for n in ("masked_attention", "scatter_add_connection")},
          f"anakin: captured {sorted(captured)}")
    del learner, loader, runner, captured, batch

    window_s = [s for s, _ in windows]
    step_ms = [ms for ms, _, _ in steps]
    result = {
        "seconds": time.perf_counter() - t_phase, "build_s": build_s, "run_s": run_s,
        "first_window_purity": first, "window_s": window_s,
        "env_steps_per_s": [ANAKIN_B * ANAKIN_T / s for s in window_s],
        "step_ms_in_window": [s * 1e3 / ANAKIN_T for s in window_s],
        "forward_ms_alone": {"median": statistics.median(fwd_ms), "all": fwd_ms, "lanes": ANAKIN_B},
        "learner_step_ms": {"loop": step_ms, "median": statistics.median(step_ms)},
        "steady_window": window_profile, "step_profile_idle_share": step_profile.get("idle_share"),
        "peak_memory_gb": peak_gb, "losses": [lg["total_loss"] for _, lg, _ in steps],
        "launches": {"run": launches, "per_window": want_window, "per_learner_step": want_step},
        "kernel_max_abs_err": errs, "away_seat": {"seconds": opp_s, "results": len(results), "winners": tally},
        "parts_s": t_sub,
        "head_to_head": h2h,
    }
    print(f"anakin ({smi}): " + json.dumps({k: v for k, v in result.items() if k != "steady_window"}))
    print(f"anakin: a steady-state window under sync debug mode 'error' and the profiler ({smi}): "
          f"{json.dumps(window_profile)}")
    print(f"anakin: a learner step on an Anakin batch profiled ({smi}): {json.dumps(step_profile)}")
    return launches, result



# ------------------------------------------------------------------ league
LEAGUE_PLAYERS = ("MP0", "EP0", "ME0")  # docs/league.md's quickstart roster
# the quickstart's 2 rounds cut to 1: with 2 the whole script ran 611.7 s
# on an NVIDIA H100 80GB HBM3 at 700 W, over its 600 s aim
LEAGUE_ROUNDS = 1
# the quickstart's sizes: 2 lanes x 3 steps a window, 2 units a squad,
# episodes of 8 steps
LEAGUE_SIZES = ("--batch-size", "2", "--traj-len", "3", "--jaxenv-units", "2", "--jaxenv-episode-len", "8")
LEAGUE_T, LEAGUE_EPISODE_LEN = 3, 8
ARENA_EPISODES, ARENA_BATCHES = 8, 3
LEAGUE_TIMEOUT_S = 420


def league_model():
    """The model block of the phase: the flagship (the learners add value
    towers), the kernel overlay, f32."""
    return overlay("pallas", "pallas")


def league_model_flags():
    return ["--full-model", "--config", json.dumps({"model": league_model()})]


def used_memory_mib():
    """The card's used memory as ``nvidia-smi`` reads it (MiB), or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=10).stdout.strip()
        return int(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def rl_train_process(tmp, name, argv):
    """``python -m distar_tpu_torch.bin.rl_train`` with ``argv`` from the
    checkout, its output to ``<tmp>/<name>.log``. Returns (Popen, log path)."""
    log = os.path.join(tmp, f"{name}.log")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-u", "-m", "distar_tpu_torch.bin.rl_train", *argv], cwd=REPO,
                                stdout=out, stderr=subprocess.STDOUT, env=env)
    return proc, log


def wait_for_line(proc, log, text, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(log) as f:
            for ln in f:
                if text in ln:
                    return ln.strip()
        check(proc.poll() is None, f"{log}: exited {proc.returncode} before '{text}': {open(log).read()[-2000:]}")
        time.sleep(0.1)
    raise SmokeFailure(f"{log}: no '{text}' within {timeout} s")


def journal_append_ms(tmp, n=64):
    """Median ms of a durable (fsync'd) and of a flushed journal append of a
    league-report-sized record on this disk, ``n`` each."""
    from distar_tpu_torch.comm.ha import Journal

    journal = Journal(os.path.join(tmp, "journal_append"))
    body = {"job_id": "J1", "learner_id": "MP0@1", "matches": [
        {"key": f"J1e{i}", "home": "MP0", "away": "EP0", "round": 0, "winner": "home", "game_steps": 8.0,
         "duration_s": 0.0} for i in range(2)]}
    out = {}
    try:
        for durable in (True, False):
            ms = []
            for _ in range(n):
                t0 = time.perf_counter()
                journal.append("league_report", body, durable=durable)
                ms.append((time.perf_counter() - t0) * 1e3)
            out["durable" if durable else "flushed"] = statistics.median(ms)
    finally:
        journal.close()
    return out


def league_journal_replay(save, digest):
    """a.'s journal cold-booted in this process with no learner running: an
    ``HAState`` on its newest snapshot, and every record applied from the
    first; each digest must equal the run's ``LEAGUE-RUN-DONE``."""
    from distar_tpu_torch.league.runtime.runner import economy_digest, replay_control_plane

    journal = os.path.join(save, "league_journal")
    files = sorted(os.listdir(journal))
    out = {"bytes": dir_bytes(journal), "files": files}
    want = {k: digest[k] for k in ("jobs_by_branch", "snapshot_mints", "historical_players", "assignments_pending",
                                   "orphaned_jobs", "off_diagonal_pairs", "matches_total")}
    for name, wal_only in (("snapshot", False), ("records", True)):
        # the run's roster, seed, lease and job TTL (rl_train's league-run)
        service, store, info = replay_control_plane(journal, LEAGUE_PLAYERS, lease_s=30.0, job_ttl_s=600.0,
                                                    wal_only=wal_only)
        got = economy_digest(service, store)
        check(got == want, f"league: the journal replayed from its {name} reads {got}, the run {want}")
        out[name] = info
    return out


def league_run_process(tmp):
    """a. ``rl_train --type league-run`` on the card: the control plane in
    its process, journaled, a learner process per player, an actor slot a
    player; then its journal cold-booted here. Returns (the run's numbers,
    the save path)."""
    import urllib.request

    save = os.path.join(tmp, "league")
    t0 = time.perf_counter()
    port = free_port()
    proc, log = rl_train_process(tmp, "league_run", [
        "--type", "league-run", *league_model_flags(), "--league-players", ",".join(LEAGUE_PLAYERS),
        "--league-rounds", str(LEAGUE_ROUNDS), *LEAGUE_SIZES, "--league-actors-per-player", "1",
        "--save-path", save, "--port", str(port)])
    used, ops = [], None
    try:
        while proc.poll() is None and time.perf_counter() - t0 < LEAGUE_TIMEOUT_S:
            mib = used_memory_mib()
            if mib is not None:
                used.append(mib)
            if ops is None:
                try:  # the control plane serves: the operator's CLI against it, once
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/league/status", timeout=5) as r:
                        ready = bool(json.loads(r.read()).get("registered_learners"))
                except (OSError, ValueError):
                    ready = False
                if ready:
                    ops = league_run_opsctl(tmp, f"127.0.0.1:{port}")
            time.sleep(1.0)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            raise SmokeFailure(f"league-run: no exit within {LEAGUE_TIMEOUT_S} s: {open(log).read()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
    wall_s = time.perf_counter() - t0
    text = open(log).read()
    check(proc.returncode == 0, f"league-run: exit {proc.returncode}: {text[-3000:]}")
    done = [ln for ln in text.splitlines() if ln.startswith("LEAGUE-RUN-DONE ")]
    check(len(done) == 1, f"league-run: no LEAGUE-RUN-DONE line: {text[-3000:]}")
    digest = json.loads(done[0][len("LEAGUE-RUN-DONE "):])
    check(digest["ok"] and digest["learner_rc"] == {p: 0 for p in LEAGUE_PLAYERS}
          and digest["snapshot_mints"] >= 1 and digest["off_diagonal_pairs"] >= 1 and digest["orphaned_jobs"] == 0,
          f"league-run: {digest}")
    for pid in LEAGUE_PLAYERS:
        check(f"league-learner {pid} device purity: {{'pure': True, 'offending': []}}" in text,
              f"league-run: {pid}'s first window not shown pure")
        for r in range(1, LEAGUE_ROUNDS + 1):
            check(f"league-learner {pid}: round {r}/{LEAGUE_ROUNDS}" in text, f"league-run: {pid} round {r} missing")
    check(ops is not None, "league-run: its coordinator never answered /league/status with a learner")
    spawn = next(ln for ln in text.splitlines() if ln.startswith("league-run: seconds from spawn to exit "))
    check("(journal=on)" in text, "league-run: the control plane was not journaled")
    fleets = {f"actors-{p}": 1 for p in sorted(LEAGUE_PLAYERS)}
    check(f"league-run: actor fleets held {json.dumps(fleets)}, left {json.dumps({k: 0 for k in fleets})}" in text,
          f"league-run: the actor fleets {[ln for ln in text.splitlines() if 'actor fleets' in ln]}")
    out = {"wall_s": wall_s, "learner_s": json.loads(spawn.split("exit ", 1)[1]), "digest": digest,
           "used_memory_mib": {"max": max(used) if used else None, "samples": len(used)},
           "journal": league_journal_replay(save, digest), "journal_append_ms": journal_append_ms(tmp),
           "opsctl": ops}
    print(f"league: a. rl_train --type league-run, {len(LEAGUE_PLAYERS)} learner processes on the card: "
          f"{json.dumps(out)}")
    return out, save


def league_run_opsctl(tmp, addr):
    """``opsctl status``, ``league`` and ``arena`` against the league-run's
    coordinator: each exits as the JAX ``opsctl`` does (status: 0 for ok,
    1 for warning, else 2, by the ``status`` it printed; league and arena:
    0)."""
    out = {}
    rc, text, sec = opsctl(tmp, "status", "status", "--addr", addr)
    said = next((ln.split()[1] for ln in text.splitlines() if ln.startswith("status: ")), None)
    check(said is not None and rc == {"ok": 0, "warning": 1}.get(said, 2),
          f"opsctl status against the league-run: exit {rc}: {text[-2000:]}")
    out["status"] = {"rc": rc, "status": said, "seconds": sec}
    rc, text, sec = opsctl(tmp, "league", "league", "--addr", addr)
    check(rc == 0 and text.startswith("league  (") and all(p in text for p in LEAGUE_PLAYERS),
          f"opsctl league against the league-run: exit {rc}: {text[-2000:]}")
    out["league"] = {"rc": rc, "seconds": sec}
    rc, text, sec = opsctl(tmp, "arena", "arena", "--addr", addr)
    check(rc == 0 and text.startswith("arena scoreboard"), f"opsctl arena against the league-run: exit {rc}: "
          f"{text[-2000:]}")
    out["arena"] = {"rc": rc, "seconds": sec}
    print(f"league: a. python -m distar_tpu_torch.tools.opsctl against the league-run's coordinator: "
          f"{json.dumps(out)}")
    return out


# a standby promotes after this long without the primary's feed
HA_TAKEOVER_GRACE_S = 1.0
# and within it plus the tail loop's 0.25 s wait and a refused probe or two
HA_PROMOTE_SLACK_S = 1.5


def arena_coordinator(tmp):
    """``--type coordinator --arena-store --journal-dir`` as a process (the
    primary of an HA pair), started (it needs nothing of a.) while a. runs.
    Returns (Popen, log path, port)."""
    port = free_port()
    return (*rl_train_process(tmp, "arena_coordinator", [
        "--type", "coordinator", "--port", str(port), "--arena-store", os.path.join(tmp, "arena_store.pkl"),
        "--journal-dir", os.path.join(tmp, "arena_journal")]), port)


def arena_processes(tmp, save, device, coordinator):
    """b. ``--type arena`` as a process on the MP0 lineage of a., against
    the HA pair of ``coordinator`` (``arena_coordinator``) and a standby
    started here, on the address list of both; the resent last batch
    dedups; the primary SIGKILLed, the standby promotes and serves the same
    ratings, and dedups the resent batch again."""
    import urllib.request

    from distar_tpu_torch.arena import match_key
    from distar_tpu_torch.comm.coordinator import coordinator_request
    from distar_tpu_torch.comm.ha import probe_ha_status

    artifact = os.path.join(tmp, "arena.json")
    co, co_log, port = coordinator
    port2 = free_port()
    spec = f"127.0.0.1:{port},127.0.0.1:{port2}"

    def ratings(at):
        with urllib.request.urlopen(f"http://127.0.0.1:{at}/arena/ratings", timeout=10) as r:
            return json.loads(r.read())

    def stop(proc, log, what):
        proc.terminate()
        check(proc.wait(timeout=60) == 0, f"{what}: exit {proc.returncode} on SIGTERM: {open(log).read()[-2000:]}")

    def role(at):
        return (probe_ha_status(f"127.0.0.1:{at}", timeout=2.0) or {}).get("role")

    t0 = time.perf_counter()
    procs = [co]
    try:
        check("coordinator HA: role=primary epoch=1" in wait_for_line(co, co_log, "coordinator HA:"),
              f"arena: the primary coordinator {open(co_log).read()[-2000:]}")
        wait_for_line(co, co_log, "coordinator serving on")
        # the standby joins the live primary (started after it: a standby
        # that reaches no primary within its grace leads)
        standby, standby_log = rl_train_process(tmp, "arena_coordinator_standby", [
            "--type", "coordinator", "--port", str(port2), "--arena-store",
            os.path.join(tmp, "arena_store_standby.pkl"), "--journal-dir", os.path.join(tmp, "arena_journal_standby"),
            "--ha-role", "standby", "--ha-peers", f"127.0.0.1:{port}", "--ha-takeover-grace-s",
            str(HA_TAKEOVER_GRACE_S)])
        procs.append(standby)
        t1 = time.perf_counter()
        arena, arena_log = rl_train_process(tmp, "arena", [
            "--type", "arena", "--coordinator-addr", spec,
            "--arena-ckpt-dir", os.path.join(save, "MP0", "checkpoints"), "--arena-roles", "MP0",
            "--arena-episodes", str(ARENA_EPISODES), "--arena-batches", str(ARENA_BATCHES),
            "--arena-artifact", artifact, *league_model_flags(), *LEAGUE_SIZES[4:]])
        procs.append(arena)
        check("coordinator HA: role=standby" in wait_for_line(standby, standby_log, "coordinator HA:"),
              f"arena: the standby coordinator {open(standby_log).read()[-2000:]}")
        check(arena.wait(timeout=300) == 0, f"arena: exit {arena.returncode}: {open(arena_log).read()[-3000:]}")
        arena_s = time.perf_counter() - t1
        batches = [ln for ln in open(arena_log).read().splitlines() if ln.startswith("arena: ")]
        check(len(batches) == ARENA_BATCHES, f"arena: {len(batches)} batches: {batches}")
        doc = json.load(open(artifact))
        got = ratings(port)
        gens = [p for p, i in got["players"].items() if p.startswith("MP0:") and i["games"] > 0]
        check(all(got["players"].get(a, {}).get("anchor") for a in ("attack_nearest", "idle")) and gens
              and got["matches_total"] == ARENA_BATCHES * ARENA_EPISODES,
              f"arena: ratings {got}")
        check(doc["batches"] == ARENA_BATCHES and doc["device"] == device.type and doc.get("ratings") == got,
              f"arena: artifact {dict((k, doc.get(k)) for k in ('batches', 'device', 'matches_per_s'))}")
        last = doc["ledger"][-1]
        resend = [{"key": match_key(last["home"], last["away"], last["round"], i), "home": last["home"],
                   "away": last["away"], "round": last["round"], "winner": "draw", "game_steps": 1,
                   "duration_s": 0.0} for i in range(last["episodes"])]
        ack = coordinator_request(spec, None, "arena_report", {"matches": resend})
        check(ack["info"] == {"applied": 0, "duplicates": last["episodes"]} and ack["role"] == "primary"
              and ack["epoch"] == 1, f"arena: the resent batch {ack}")
        before = ratings(port)
        check(before["duplicates_total"] == got["duplicates_total"] + last["episodes"]
              and before["matches_total"] == got["matches_total"], f"arena: after the resend {before}")
        # every acknowledged record is on the standby (semi-synchronous)
        pst, sst = probe_ha_status(f"127.0.0.1:{port}"), probe_ha_status(f"127.0.0.1:{port2}")
        check(pst["followers"] == 1 and sst["role"] == "standby" and sst["seq"] == pst["seq"],
              f"arena: the pair before the kill: primary {pst}, standby {sst}")
        co.kill()
        co.wait()
        t2 = time.perf_counter()
        while role(port2) != "primary":
            check(time.perf_counter() - t2 < HA_TAKEOVER_GRACE_S + 30, "arena: the standby never promoted")
            time.sleep(0.02)
        promote_s = time.perf_counter() - t2
        check(promote_s < HA_TAKEOVER_GRACE_S + HA_PROMOTE_SLACK_S,
              f"arena: the standby promoted {promote_s:.2f} s after the kill (grace {HA_TAKEOVER_GRACE_S} s)")
        after = ratings(port2)
        check(after == before, f"arena: the promoted standby serves other ratings: {after} against {before}")
        again = coordinator_request(spec, None, "arena_report", {"matches": resend})
        check(again["info"] == {"applied": 0, "duplicates": last["episodes"]} and again["role"] == "primary"
              and again["epoch"] == 2, f"arena: the resent batch on the promoted standby {again}")
        stop(standby, standby_log, "arena coordinator (promoted standby)")
        text = open(standby_log).read()
        check("coordinator journal snapshotted on shutdown" in text and "arena store journaled on shutdown" in text,
              f"arena: the promoted standby's shutdown {text[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {"seconds": time.perf_counter() - t0, "arena_process_s": arena_s, "standby_promote_s": promote_s,
           "takeover_grace_s": HA_TAKEOVER_GRACE_S, "resend_after_failover": again["info"],
           "batch_s": [e["duration_s"] for e in doc["ledger"]], "matches_per_s": doc["matches_per_s"],
           "pairs": [(e["home"], e["away"]) for e in doc["ledger"]], "rated_generations": sorted(gens),
           "resend": ack, "skill": doc.get("arena")}
    print(f"league: b. rl_train --type coordinator --arena-store --journal-dir, a standby and --type arena as "
          f"processes: {json.dumps(out)}")
    return out


def league_processes(tmp, device):
    """a. and b. of the league phase: the economy and the arena as
    processes (b.'s coordinator starting while a. runs). In the whole
    script they run on a thread from the start of phases 12-14. Returns (a.'s
    numbers, b.'s, a.'s save path)."""
    import torch

    reserved_mib = torch.cuda.memory_reserved() / 2 ** 20
    coordinator = arena_coordinator(tmp)
    try:
        run, save_dir = league_run_process(tmp)
    except BaseException:
        coordinator[0].kill()
        coordinator[0].wait()
        raise
    run["script_reserved_mib"] = reserved_mib
    return run, arena_processes(tmp, save_dir, device, coordinator), save_dir


def phase_league(device, smi, tmp, anakin=None, processes=None):
    """The league economy on the card (module docstring, phase 13).
    ``anakin``: what phase_anakin returned (its window and step ms are
    printed beside this phase's), or None when the phase runs alone;
    ``processes``: what ``league_processes`` returned on its thread, or None
    to run it here first. Returns the launch counts of c. (its windows,
    learner steps and arena batch) and the measurements."""
    import torch

    from distar_tpu_torch.arena import ArenaEvaluator, ArenaStore, set_arena_store
    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.comm import Coordinator, CoordinatorServer
    from distar_tpu_torch.league.runtime import LeagueService, set_league_service
    from distar_tpu_torch.league.runtime.runner import league_cfg
    from distar_tpu_torch.ops import build
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.utils.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    run, arena, save_dir = processes if processes is not None else league_processes(tmp, device)

    # c. one learner in this process against a control plane of the phase:
    # EP0, whose one historical opponent is MP0's newest generation of a.
    gen = CheckpointManager(os.path.join(save_dir, "MP0", "checkpoints"), role="MP0").generations()[0]
    store = ArenaStore()
    set_arena_store(store)
    cfg = league_cfg(LEAGUE_PLAYERS)
    cfg["league"]["save_initial_snapshot"] = False
    service = LeagueService(cfg, seed=0)
    set_league_service(service)
    minted = service.train_info({"player_id": "MP0", "seq": 0, "generation_path": gen["path"]})
    server = CoordinatorServer(coordinator=Coordinator(), port=0)
    server.start()
    try:
        args = rl_train.parser().parse_args([
            "--type", "league-learner", "--player-id", "EP0", "--coordinator-addr", f"127.0.0.1:{server.port}",
            "--league-rounds", "1", *league_model_flags(), *LEAGUE_SIZES, "--save-path",
            os.path.join(tmp, "league_in_process"), "--device", device.type, "--no-supervise"])
        rl_train._resolve_args(args)
        t0 = time.perf_counter()
        learner, loader, loop, first = rl_train.build_league_learner(args)
        build_s = time.perf_counter() - t0
        check(first == {"pure": True, "offending": []}, f"league: the first window is not device-pure: {first}")
        layers = int(learner.model_cfg.encoder.entity.layer_num)
        runner = loader.runner

        # instruments, outside the port: each window's and step's time and
        # launches, each kernel's first call on each side, the control
        # plane's round trips, the saves
        side, windows, steps, captured, calls, saves = {"now": None}, [], [], {}, {}, []
        real = {"train": learner._train, "attention": K.masked_attention, "scatter": K.scatter_add_connection,
                "sample": runner._sample, "save": learner.save}

        class Windows:
            def __iter__(self):
                return self

            def __next__(self):
                before = dict(K.launch_counts)
                side["now"] = "window"
                t0 = time.perf_counter()
                batch = next(loader)  # the away seat's outcomes are read back after the window
                windows.append((time.perf_counter() - t0, {n: K.launch_counts[n] - before[n]
                                                           for n in build.KERNELS}))
                side["now"] = None
                return batch

            def drain_results(self):
                return loader.drain_results()

        def train(data):
            before = dict(K.launch_counts)
            side["now"] = "learner step"
            t0 = time.perf_counter()
            log = real["train"](data)
            steps.append(((time.perf_counter() - t0) * 1e3, log, {n: K.launch_counts[n] - before[n]
                                                                   for n in build.KERNELS}))
            side["now"] = None
            return log

        def sample(model, obs, hidden, noise):
            outer = side["now"]
            if outer == "window" and model is not learner.model:
                side["now"] = "away seat"
            try:
                return real["sample"](model, obs, hidden, noise)
            finally:
                side["now"] = outer

        def attention(q, k, v, mask):
            key = (side["now"], "masked_attention")
            if side["now"] and key not in captured:
                captured[key] = [t.detach().clone() for t in (q, k, v, mask)]
            return real["attention"](q, k, v, mask)

        def scatter(emb, idx, hw):
            key = (side["now"], "scatter_add_connection")
            if side["now"] and key not in captured:
                captured[key] = (emb.detach().clone(), idx.clone(), hw)
            return real["scatter"](emb, idx, hw)

        def timed_save(path, sync=False):
            t0 = time.perf_counter()
            real["save"](path, sync=sync)
            saves.append({"sync": sync, "s": time.perf_counter() - t0})

        def timed_call(name, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                calls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        remote = loop.remote
        for name in ("register_learner", "ask_job", "report", "train_info"):
            setattr(remote, name, timed_call(name, getattr(remote, name)))
        counts = ThreadCounts(build.KERNELS)
        real_counts, K.launch_counts = K.launch_counts, counts
        wrapped = Windows()
        learner.set_dataloader(wrapped)
        loop.loader = wrapped
        learner._train, learner.save, runner._sample = train, timed_save, sample
        K.masked_attention, K.scatter_add_connection = attention, scatter
        try:
            K.reset_launch_counts()
            counts.by_side = {s: {n: 0 for n in build.KERNELS} for s in ("learner", "actor")}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = loop.run()
            loop_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            loop_launches = dict(counts)
            # the arena: one evaluate_once of a.'s MP0 generations against the anchors
            evaluator = ArenaEvaluator(os.path.join(save_dir, "MP0", "checkpoints"), league_model(),
                                       store=ArenaStore(), roles=("MP0",), episodes=ARENA_EPISODES,
                                       env_cfg=runner.env_cfg, scenario_cfg=runner.gen.cfg, device=device)
            before = dict(K.launch_counts)
            side["now"] = "arena batch"
            t0 = time.perf_counter()
            ev = evaluator.evaluate_once()
            arena_batch_s = time.perf_counter() - t0
            side["now"] = None
            arena_launches = {n: K.launch_counts[n] - before[n] for n in build.KERNELS}
            launches = dict(counts)
            other_threads = dict(counts.by_side["actor"])
        finally:
            K.launch_counts = real_counts
            K.masked_attention, K.scatter_add_connection = real["attention"], real["scatter"]
            learner._train, learner.save = real["train"], real["save"]
            del runner._sample
        status = service.status()
    finally:
        server.stop()
        set_arena_store(None)
        set_league_service(None)

    # what the learner did: one round against the frozen generation
    rnd = out["rounds"][0]
    check(out["jobs"] == 1 and out["mints"] == 1 and rnd["away"] == minted["snapshot_id"]
          and rnd["branch"] == "pfsp" and rnd["matches"] >= 1, f"league: the in-process round {out}")
    check(status["snapshot_mints"] == 2 and status["assignments_pending"] == 0 and store.matches_total == rnd["matches"],
          f"league: the control plane after the round {status['snapshot_mints']} {store.matches_total}")
    check(len(steps) == 1 and all(finite(lg) for _, lg, _ in steps), f"league: learner steps {steps}")
    check(not any(other_threads.values()), f"league: launches from another thread {other_threads}")
    want_window = {"masked_attention": 2 * layers * LEAGUE_T, "scatter_add_connection": 2 * LEAGUE_T,
                   "scatter_add_onehot": 0}
    want_step = {"masked_attention": layers, "scatter_add_connection": 1, "scatter_add_onehot": 0}
    want_arena = {"masked_attention": layers * LEAGUE_EPISODE_LEN, "scatter_add_connection": LEAGUE_EPISODE_LEN,
                  "scatter_add_onehot": 0}
    check(windows and all(n == want_window for _, n in windows),
          f"league: launches per window {[n for _, n in windows]}, want {want_window}")
    check(all(n == want_step for _, _, n in steps), f"league: launches per learner step {[n for _, _, n in steps]}")
    a = ev["assignment"]
    check({a["home"], a["away"]} == {f"MP0:{gen['step']}", "attack_nearest"} and ev["ack"]["applied"] == ARENA_EPISODES
          and arena_launches == want_arena, f"league: the arena batch {a} {ev['ack']} launches {arena_launches}")
    check(loop_launches["masked_attention"] == len(windows) * want_window["masked_attention"] + layers,
          f"league: the loop launched {loop_launches}")
    errs = path_kernels_against_plain(K, captured, "league")
    check(set(captured) == {(s, n) for s in ("window", "away seat", "learner step", "arena batch")
                            for n in ("masked_attention", "scatter_add_connection")},
          f"league: captured {sorted(captured)}")
    del learner, loader, loop, runner, evaluator, captured

    window_ms = [s * 1e3 for s, _ in windows]
    result = {
        "seconds": time.perf_counter() - t_phase, "league_run": run, "arena": arena,
        "in_process": {
            "build_s": build_s, "loop_s": loop_s, "first_window_purity": first, "round": rnd,
            "window_ms": window_ms, "step_ms": [ms for ms, _, _ in steps],
            "anakin_window_ms_per_step": None if anakin is None else anakin["step_ms_in_window"],
            "anakin_learner_step_ms": None if anakin is None else anakin["learner_step_ms"]["median"],
            "control_plane_ms": calls, "saves": saves, "peak_memory_gb": peak_gb,
            "arena_batch_s": arena_batch_s, "arena_matches_per_s": ARENA_EPISODES / arena_batch_s,
            "arena_winners": {w: sum(m["winner"] == w for m in ev["result"]["matches"])
                              for w in ("home", "away", "draw")}},
        "launches": {"run": launches, "per_window": want_window, "per_learner_step": want_step,
                     "per_arena_batch": want_arena},
        "kernel_max_abs_err": errs,
    }
    print(f"league ({smi}): " + json.dumps(result))
    return launches, result


def league_summary(league):
    """The league phase's headline numbers."""
    ip = league["in_process"]
    return {"league_run_wall_s": league["league_run"]["wall_s"], "learner_s": league["league_run"]["learner_s"],
            "used_memory_mib": league["league_run"]["used_memory_mib"]["max"],
            "script_reserved_mib": league["league_run"]["script_reserved_mib"],
            "window_ms": ip["window_ms"], "step_ms": ip["step_ms"],
            "control_plane_ms": {k: statistics.median(v) for k, v in ip["control_plane_ms"].items()},
            "sync_save_s": [x["s"] for x in ip["saves"] if x["sync"]], "peak_memory_gb": ip["peak_memory_gb"],
            "arena_batch_s": league["arena"]["batch_s"], "arena_matches_per_s": league["arena"]["matches_per_s"],
            "in_process_arena_batch_s": ip["arena_batch_s"],
            "journal": {"bytes": league["league_run"]["journal"]["bytes"],
                        "records": league["league_run"]["journal"]["records"]["records"],
                        "replay_s": {k: league["league_run"]["journal"][k]["seconds"] for k in ("snapshot", "records")},
                        "append_ms": league["league_run"]["journal_append_ms"]},
            "standby_promote_s": league["arena"]["standby_promote_s"], "seconds": league["seconds"]}


# ---------------------------------------------------------------- parallel
# b.'s floor where two unmeshed repeats agree to the bit: a meshed step on a
# world of one runs the unmeshed step's code (every collective is skipped),
# so it may part from it only as two repeats part (the card's backward does
# not repeat bit for bit, ``rl_gap``)
PAR_FLOOR = 1e-6


def executor_processes(tmp, device):
    """f. the executor's kill and resume at the smoke model as ``python -m
    distar_tpu_torch.tools.chaos multichip-drill --mesh dp=1 --resume-mesh
    dp=1 --host-devices 0 --iters 2 --kill-after 1`` on the card: the
    executor killed with 137 after its sharded save at iteration 1, resumed
    from that generation to iteration 2 unassisted; its verdict, and the
    newest generation sharded and verified."""
    from distar_tpu_torch.parallel.ckpt import is_sharded_checkpoint
    from distar_tpu_torch.utils.checkpoint import CheckpointManager, verify_checkpoint

    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": REPO, "DISTAR_PERF_AOT": "0"}
    drill = os.path.join(tmp, "multichip_drill")
    log = os.path.join(tmp, "multichip_drill.log")
    with open(log, "w") as f, open(log + ".err", "w") as err:
        rc = subprocess.run([sys.executable, "-m", "distar_tpu_torch.tools.chaos", "multichip-drill", "--dir", drill,
                             "--mesh", "dp=1", "--resume-mesh", "dp=1", "--host-devices", "0", "--iters", "2",
                             "--kill-after", "1", "--restart-max", "1", "--timeout-s", "600",
                             "--device", device.type], cwd=REPO, env=env, stdout=f, stderr=err,
                            timeout=1200).returncode
    said = open(log).read()
    lines, text = said.strip().splitlines(), said + open(log + ".err").read()[-2000:]
    check(rc == 0 and len(lines) >= 2 and "finished unassisted" in lines[-1],
          f"chaos multichip-drill: exit {rc}: {text[-3000:]}")
    verdict = json.loads(lines[-2])
    check(verdict["final_iters"] == 2 and verdict["resume_start_iter"] == 1 and verdict["restarts"] == 1
          and verdict["killed_after"] == 1 and verdict["resumed_from"].endswith("iteration_1.ckpt")
          and verdict["mesh_resumed"] == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1},
          f"chaos multichip-drill: verdict {verdict}")
    gen = CheckpointManager(os.path.join(drill, "exp", "checkpoints")).generations()[0]
    check(is_sharded_checkpoint(gen["path"]) and verify_checkpoint(gen["path"]),
          f"chaos multichip-drill: the newest generation {gen} does not verify")
    print(f"parallel f: chaos multichip-drill on the card: {lines[-1]}")
    return {"verdict": verdict, "newest_generation_step": gen["step"], "seconds": time.perf_counter() - t0}


# g.: two gloo ranks on the one card; dp=2 splits the rows as fsdp=2 does
# and no parameter: the yardstick of a step whose ops run at other shapes
MESH_G = ({"dp": 2}, {"dp": 1, "fsdp": 2}, {"dp": 1, "tp": 2})
# g.: the tolerances of tests/test_torch_parallel_ranks.py (scalars relative to
# max(1, |v|), each step's parameters to that step's norm, the moments to theirs)
G_SCALAR_RTOL, G_UPDATE_RTOL, G_MOMENT_RTOL = 1e-5, 2e-4, 1e-4
# g.: the parts of a run held against another: the first step's forward scalars
# (its losses) and gradient scalars, each step's parameters, the second step's
# scalars, the moments after it; in shares of the tolerances above
G_PARTS = ("forward1", "grads1", "step1", "scalars2", "step2", "moments")
# g.: the fixed bounds against the single-process step: the forward at the tests'
# tolerance; what reads a gradient within GRAD_TOL relative, the card's gradient
# gap at other shapes of the same ops (ROADMAP Queue 3 items 1 and 72)
G_BOUND = {"forward1": 1.0, "grads1": GRAD_TOL / G_SCALAR_RTOL, "step1": GRAD_TOL / G_UPDATE_RTOL,
           "scalars2": GRAD_TOL / G_SCALAR_RTOL, "step2": GRAD_TOL / G_UPDATE_RTOL,
           "moments": GRAD_TOL / G_MOMENT_RTOL}
# g.: fsdp=2 against dp=2 (the same rows, the parameters gathered): the first step
# at the tests' tolerances throughout, the rest as above
G_BOUND_DP = {**G_BOUND, "grads1": 1.0, "step1": 1.0}
# g.: the info keys that read a gradient (the rest of the first step's are its forward)
G_GRAD_KEYS = ("grad_norm", "dyn/grad_norm/", "dyn/update_ratio/", "dyn/clip_", "dyn/nonfinite_grads/")


def step_off(a, b, prev):
    """||a - b|| over the step ||b - prev|| (lists of arrays, in float64)."""
    import numpy as np

    num = sum(float(((x.astype(np.float64) - y) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float(((y.astype(np.float64) - z) ** 2).sum()) for y, z in zip(b, prev))
    return (num / den) ** 0.5


def g_distance(got, want):
    """g.: how far a run's two steps lie from ``want``'s, in shares of the
    tests' tolerances: the worst scalar (G_SCALAR_RTOL of max(1, |v|)) and
    its key of the first step's forward, of its gradient scalars and of
    the second step, each step's parameters (G_UPDATE_RTOL of that step's
    norm, from ``want["start"]``), the moments after the second
    (G_MOMENT_RTOL of their norm)."""
    out, prev = {}, want["start"]
    for step in range(2):
        mine, theirs = got["logs"][step], want["logs"][step]
        if set(mine) != set(theirs):
            raise ValueError(f"step {step}: info keys differ")
        shares = {k: abs(mine[k] - v) / (G_SCALAR_RTOL * max(1.0, abs(v))) for k, v in theirs.items()}
        groups = {"scalars2": shares} if step else {
            "forward1": {k: v for k, v in shares.items() if not k.startswith(G_GRAD_KEYS)},
            "grads1": {k: v for k, v in shares.items() if k.startswith(G_GRAD_KEYS)}}
        for part, group in groups.items():
            key = max(group, key=group.get)
            out[part], out[f"{part}_key"] = group[key], key
        out[f"step{step + 1}"] = step_off(got["params"][step], want["params"][step], prev) / G_UPDATE_RTOL
        prev = want["params"][step]
    moments = rel_dist([x for m in got["moments"] for x in m], [x for m in want["moments"] for x in m])
    return {**out, "moments": moments / G_MOMENT_RTOL}


def gloo_cuda_collectives(rank, world):
    """g.: each collective the meshed learner runs, once on CUDA tensors in
    the ranks' gloo group, against its known result: ``{name: "ok" |
    "wrong result" | "refused: <error>"}``."""
    import torch
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
    rows = [torch.arange(4, dtype=torch.float32) + 10 * r for r in range(world)]
    total, gathered = sum(rows), torch.cat(rows)

    def gather_list():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def gather_tensor():
        out = torch.empty(4 * world, device="cuda")
        dist.all_gather_into_tensor(out, x)
        return out

    def reduce(y):
        dist.all_reduce(y)
        return y

    def scatter_list():
        out = torch.empty(4 // world, device="cuda")
        dist.reduce_scatter(out, list(x.clone().chunk(world)))
        return out

    def scatter_tensor():
        out = torch.empty(4 // world, device="cuda")
        dist.reduce_scatter_tensor(out, x.clone())
        return out

    def broadcast(y):
        dist.broadcast(y, 0)
        return y

    mine = total.chunk(world)[rank]
    result = {}
    for name, fn, want in (("all_gather", gather_list, gathered), ("all_gather_into_tensor", gather_tensor, gathered),
                           ("all_reduce", lambda: reduce(x.clone()), total),
                           ("reduce_scatter", scatter_list, mine), ("reduce_scatter_tensor", scatter_tensor, mine),
                           ("broadcast", lambda: broadcast(x.clone()), rows[0])):
        try:
            got = fn()
            torch.cuda.synchronize()
            result[name] = "ok" if got.device.type == "cuda" and torch.equal(got.cpu(), want) else "wrong result"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            result[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        dist.barrier()
    return result


def mesh_rank(rank, tmp, batch_path):
    """g. one of two gloo ranks on the card (``spawn_ranks(...,
    device="cuda")``), with deterministic algorithms (cuBLAS's fixed
    workspace, cuDNN's deterministic convolutions; each op that has no
    deterministic version is recorded by its warning). First the gloo
    collectives on CUDA tensors (``gloo_cuda_collectives``); then each
    rank's own unmeshed flagship RL learner (kernel overlay, f32, 4 x 16,
    six value towers), two steps on the rl phase's batch: the
    single-process reference, in the ranks' own processes, and its repeat
    on the other rank. Then for each mesh of MESH_G the same learner, two
    steps, each read from zero counts. Of each run: its bytes between the
    steps (``memory_allocated`` from before the learner was built) and at
    a step's peak, the heads ``masked_attention`` saw, the kernel against
    its plain version on the run's first attention inputs (kept on the
    host, so they add no card bytes), the step ms, its blocks' elements;
    rank 0 gathers the parameters whole after each step and the moments
    after the second (collectives: both ranks) and holds them against the
    reference (``g_distance``), fsdp=2 against dp=2 too. Each rank writes
    one JSON file."""
    import gc
    import pickle
    import warnings

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # read at the first cuBLAS call
    import torch
    import torch.distributed as dist

    from distar_tpu_torch.learner import RLLearner
    from distar_tpu_torch.obs.perf import to_meta
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.parallel import MeshSpec, make_mesh, set_context_mesh
    from distar_tpu_torch.parallel.spmd import param_shards

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    with open(batch_path, "rb") as f:
        batch = pickle.load(f)
    heads, first, real = [], [], K.masked_attention

    def attention(q, k, v, mask):
        heads.append(int(q.shape[1]))
        if not first:  # this run's first inputs, on the host
            first.append([t.detach().to("cpu", copy=True) for t in (q, k, v, mask)])
        return real(q, k, v, mask)

    K.masked_attention = attention
    info = {"gloo_cuda": gloo_cuda_collectives(rank, dist.get_world_size())}
    cfg = {"learner": {"batch_size": RL_B, "unroll_len": RL_T}, "model": overlay(*STRINGS["pallas"])}
    runs, alerts = {}, set()
    for spec in (None,) + MESH_G:
        name = "single" if spec is None else ",".join(f"{k}={v}" for k, v in spec.items())
        mesh = None if spec is None else make_mesh(MeshSpec(**spec))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        lrn = RLLearner(cfg, device="cuda", mesh=mesh)
        shards = param_shards(lrn.model)
        run = {"logs": [], "params": [],
               "start": [t.float().to("cpu", copy=True).numpy() for t in shards.whole(lrn.optimizer.params)]}
        rec = {"launches": [], "ms": [], "between_mb": [], "peak_mb": []}
        seen = []  # the batch each step hands the perf monitor's flop count, as meta tensors (no card bytes)
        lrn._perf_note_step = lambda b: seen.append(to_meta(b))
        first.clear()
        for _ in range(2):
            heads.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as said:
                warnings.simplefilter("always")
                run["logs"].append(lrn._train(batch))
                torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append(dict(K.launch_counts))
            rec["peak_mb"].append((torch.cuda.max_memory_allocated() - base) / 1e6)
            rec["between_mb"].append((torch.cuda.memory_allocated() - base) / 1e6)
            rec["heads"] = sorted(set(heads))
            alerts.update(str(w.message).splitlines()[0][:200] for w in said if "determinis" in str(w.message))
            run["params"].append([t.float().to("cpu", copy=True).numpy() for t in shards.whole(lrn.optimizer.params)])
        q, k, v, mask = (t.to("cuda") for t in first[0])
        with torch.no_grad():
            want = K.masked_attention_plain(q, k, v, mask)
            err = float((real(q, k, v, mask) - want).abs().max())
        rec["attention_check"] = {"shape": list(q.shape), "max_abs_err": err, "max_abs_plain": float(want.abs().max())}
        del want
        if name in ("single", "dp=1,tp=2"):
            # the perf monitor's count of this rank's step (after the timed
            # steps: its thread would share their host), and its gauges read
            # at the second step's time
            lrn._perf.note_step(lrn._flop_counter(seen[0]))
            lrn._perf.analysis.join()
            lrn._perf.on_step(rec["ms"][1] / 1e3, RL_B * RL_T)
            rec["perf"] = {k: lrn._perf.last.get(k) for k in ("implied_tflops", "mfu")}
            rec["perf"]["flops_per_step"] = lrn._perf.flops_per_step
        del q, k, v, mask
        opt = lrn.optimizer
        rec["block_numel"] = {k: sum(t.numel() for t in v) for k, v in
                              (("params", opt.params), ("mu", opt.mu), ("nu", opt.nu))}
        rec["whole_numel"] = sum(t.numel() for t in shards.whole(opt.params))
        run["moments"] = [[t.float().to("cpu", copy=True).numpy() for t in shards.whole(m)] for m in (opt.mu, opt.nu)]
        info[name] = rec
        if rank == 0 or spec is None:
            runs[name] = run
        del lrn, shards, opt, run
        set_context_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()
    info["nondeterministic_ops"] = sorted(alerts)
    # the repeat: rank 1's reference beside rank 0's
    repeat = os.path.join(tmp, "mesh_g_repeat.pkl")
    if rank == 1:
        with open(repeat, "wb") as f:
            pickle.dump(runs["single"], f)
    dist.barrier()
    if rank == 0:
        ref = runs["single"]
        with open(repeat, "rb") as f:
            off = {"repeat": g_distance(pickle.load(f), ref)}
        off.update({name: g_distance(run, ref) for name, run in runs.items() if name != "single"})
        off["dp=1,fsdp=2 against dp=2"] = g_distance(runs["dp=1,fsdp=2"], runs["dp=2"])
        info["off"] = off
    with open(os.path.join(tmp, f"mesh_g_{rank}.json"), "w") as f:
        json.dump(info, f)


def mesh_rank_processes(tmp, batch):
    """g. the two gloo ranks on the card (``mesh_rank``), on a thread
    beside other phases (they launch nothing in this process); returns
    each rank's record and the seconds from spawn to exit."""
    import pickle

    from distar_tpu_torch.parallel.dist import spawn_ranks

    t0 = time.perf_counter()
    path = os.path.join(tmp, "mesh_g_batch.pkl")
    with open(path, "wb") as f:
        pickle.dump(batch, f)
    codes = spawn_ranks(mesh_rank, 2, tmp, path, timeout_s=600.0, device="cuda")
    check(codes == [0, 0], f"parallel g: the two gloo ranks on the card exited {codes}")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"mesh_g_{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def same_state(a, b):
    """Every array leaf of two learner states bit-equal (their flax trees)."""
    import numpy as np

    la, lb = array_leaves(a), array_leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).shape == np.asarray(y).shape
        and np.array_equal(np.asarray(x).reshape(-1).view(np.uint8), np.asarray(y).reshape(-1).view(np.uint8))
        for x, y in zip(la, lb))


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_parallel(device, smi, tmp, batch, executor_job=None, mesh_job=None):
    """``parallel/`` on the card (module docstring, phase 14): a world of
    one, and two gloo ranks on the card (``mesh_job``: g.). Returns the
    launch counts of its meshed paths and the measurements."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distar_tpu_torch.learner import RLLearner
    from distar_tpu_torch.learner.data import as_float32
    from distar_tpu_torch.model.convert import learner_state_to_flax
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.parallel import MeshSpec, make_mesh
    from distar_tpu_torch.parallel.dist import dist_init
    from distar_tpu_torch.parallel.ring_attention import ring_self_attention
    from distar_tpu_torch.utils.checkpoint import CheckpointCorruptError, load_checkpoint, verify_checkpoint

    laps, out, launches = Laps(), {}, {}
    # a. the process group
    info = dist_init(method="single_node", device="cuda")
    x = torch.arange(8, dtype=torch.float32, device=device)
    y = x.clone()
    dist.all_reduce(y)
    check(info["backend"] == "nccl" and info["world_size"] == 1 and torch.equal(x, y),
          f"process group {info}: all_reduce gave {y.tolist()}")
    out["group"] = {**info, "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    print(f"parallel a: process group {out['group']}, all_reduce of a world of one gives its input back")
    laps("a group")

    # b. the meshed flagship step against two unmeshed repeats
    mesh = make_mesh(MeshSpec(dp=1))
    cfg = {"learner": {"batch_size": RL_B, "unroll_len": RL_T, "sharded_ckpt": True},
           "model": overlay(*STRINGS["pallas"])}
    refs = [rl_learner(device) for _ in range(2)]
    meshed = RLLearner(cfg, device=device, mesh=mesh)
    logs = [lrn._train(batch) for lrn in refs]
    K.reset_launch_counts()
    log_m = meshed._train(batch)
    launches["meshed step"] = dict(K.launch_counts)
    want = {"masked_attention": meshed.model_cfg.encoder.entity.layer_num, "scatter_add_connection": 1,
            "scatter_add_onehot": 0}
    check(launches["meshed step"] == want, f"meshed step launches {launches['meshed step']}, want {want}")
    worst = {}
    for k in log_m:
        a, b, m = logs[0][k], logs[1][k], log_m[k]
        tol = max(2 * abs(a - b), PAR_FLOOR * max(1.0, abs(a)))
        worst[k] = abs(m - a) / tol
        check(abs(m - a) <= tol, f"meshed step {k}: {m} against {a} (repeat {b}), tolerance {tol:.3g}")
    env = rel_dist(params_of(refs[1]), params_of(refs[0]))
    dist_p = rel_dist(params_of(meshed), params_of(refs[0]))
    check(dist_p <= max(2 * env, PAR_FLOOR), f"meshed params {dist_p:.3g} from unmeshed, envelope {env:.3g}")
    ms, all_ms = step_times({"meshed": meshed, "unmeshed": refs[0]}, batch, rounds=3, warmup=1)
    out["step"] = {"meshed_ms": ms["meshed"], "unmeshed_ms": ms["unmeshed"], "params_dist": dist_p,
                   "params_envelope": env, "worst_scalar_share_of_tolerance": max(worst.values())}
    print(f"parallel b ({smi}): meshed dp=1 step against two unmeshed repeats: {len(log_m)} scalars within "
          f"max(2 x envelope, {PAR_FLOOR:g} rel) (worst {max(worst.values()):.3g} of it), params {dist_p:.3g} "
          f"(envelope {env:.3g}); step ms median of 3: meshed {ms['meshed']:.2f} unmeshed {ms['unmeshed']:.2f} "
          f"(all {json.dumps(all_ms)}); launches {launches['meshed step']}")
    laps("b step")

    # c. the sharded checkpoint at the flagship: params, mu, nu and count
    ck = os.path.join(tmp, "parallel_ckpt")
    first = os.path.join(ck, "iteration_1.ckpt")
    t0 = time.perf_counter()
    meshed.save(first, sync=True)
    save_s = time.perf_counter() - t0
    check(verify_checkpoint(first), f"{first} does not verify")
    nbytes = dir_bytes(first)
    fresh = refs[1]  # an unmeshed learner one step away: the restore replaces all of it
    t0 = time.perf_counter()
    fresh.restore(first)
    restore_s = time.perf_counter() - t0
    check(same_state(learner_state_to_flax(fresh.model, fresh.optimizer),
                     learner_state_to_flax(meshed.model, meshed.optimizer)),
          "a sharded checkpoint restored into an unmeshed learner is not bit-equal")
    # async: the loop's blocked time against the write's
    meshed._train(batch)
    meshed.last_iter.update(2)
    second = os.path.join(ck, "iteration_2.ckpt")
    t0 = time.perf_counter()
    meshed.save(second)
    blocked_s = time.perf_counter() - t0
    meshed._checkpointer.wait()
    write_s = time.perf_counter() - t0
    gens = [g["path"] for g in meshed.checkpoint_manager.generations()]
    check(gens[:2] == [second, first], f"generations {gens}")
    shard = max((f for f in os.listdir(second) if f.endswith(".shard")),
                key=lambda f: os.path.getsize(os.path.join(second, f)))
    with open(os.path.join(second, shard), "r+b") as f:
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        load_checkpoint(second)
        check(False, f"{second} with a flipped byte loads")
    except CheckpointCorruptError:
        pass
    back = refs[0]
    back._ckpt_manager = meshed.checkpoint_manager
    check(back.resume_latest() == first, "resume_latest did not fall back past the corrupt generation")
    out["ckpt"] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s, "async_blocked_s": blocked_s,
                   "async_write_s": write_s, "shards": len([f for f in os.listdir(first) if f.endswith(".shard")])}
    print(f"parallel c ({smi}): sharded checkpoint {nbytes} B in {out['ckpt']['shards']} shards, sync save "
          f"{save_s:.2f} s, restore into an unmeshed learner {restore_s:.2f} s (bit-equal); async save blocked "
          f"the loop {blocked_s:.3f} s of its {write_s:.2f} s; a flipped byte in {shard} fails the generation "
          f"and resume_latest falls back to {os.path.basename(first)}")
    del fresh, back, refs
    laps("c checkpoint")

    # d. run() through the ShardFeeder at depth 2, placed batches held to the host ones
    placed, host = [], []
    real_place = meshed._place_batch

    def place(b):
        host.append(as_float32(meshed._cap({k: v for k, v in b.items() if k != "model_last_iter"})))
        out_b = real_place(b)
        placed.append(out_b)
        return out_b

    meshed._place_batch = place
    meshed.cfg.learner["prefetch_depth"] = 2
    meshed.cfg.learner["save_freq"] = 10 ** 9
    meshed.set_dataloader(iter([batch] * 6))
    before = {k: v for k, v in meshed.metrics.snapshot().items() if k.startswith("distar_feeder_")}
    K.reset_launch_counts()
    meshed.run(meshed.last_iter.val + 3)
    launches["run through the feeder"] = dict(K.launch_counts)
    feeder = meshed._dataloader
    from distar_tpu_torch.parallel import ShardFeeder

    check(isinstance(feeder, ShardFeeder), f"the learner's prefetch wrapper is {type(feeder).__name__}")
    stats = feeder.stats()
    feeder.close()
    for h, p in zip(host, placed):
        for want_leaf, got_leaf in zip(array_leaves(h), array_leaves({key: p[key] for key in h})):
            check(np.array_equal(np.asarray(want_leaf), got_leaf.cpu().numpy()),
                  "a placed batch differs from the host's")
    counts = {k: v - before.get(k, 0) for k, v in meshed.metrics.snapshot().items()
              if k.startswith("distar_feeder_batches_total")}
    check(stats["batches"] == 3, f"feeder stats {stats}")
    out["feeder"] = {**stats, "counts": counts, "step_ms": ms["meshed"]}
    print(f"parallel d ({smi}): 3 iterations of run() through the ShardFeeder at depth 2: mean wait "
          f"{stats['wait_s_mean'] * 1e3:.3f} ms against a {ms['meshed']:.2f} ms step, place "
          f"{stats['place_s_mean'] * 1e3:.2f} ms; {len(placed)} placed batches bit-equal to the host ones; "
          f"counts {counts}; launches {launches['run through the feeder']}")
    del meshed
    laps("d feeder")

    # e. ring attention at sp=1 at the RL shape against 'pallas' and 'xla'
    rng = np.random.default_rng(14)
    B, H, N, Dh = RL_B * (RL_T + 1), 2, 512, 128
    q, k, v = (torch.tensor(rng.standard_normal((B, H, N, Dh)), dtype=torch.float32, device=device)
               for _ in range(3))
    mask = torch.tensor(np.arange(N)[None, :] < rng.integers(1, N + 1, size=(B, 1)), device=device)
    got = ring_self_attention(q, k, v, mask, None)
    err = {"pallas": float((got - K.masked_attention(q, k, v, mask)).abs().max()),
           "xla": float((got - K.masked_attention_plain(q, k, v, mask, upcast=False)).abs().max())}
    dout = torch.tensor(rng.standard_normal((B, H, N, Dh)), dtype=torch.float32, device=device)
    grads = []
    for fn in (lambda *t: ring_self_attention(*t, mask, None),
               lambda *t: K.masked_attention_plain(*t, mask, upcast=False)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * dout).sum().backward()
        grads.append([t.grad for t in leaves])
    err["grad"] = max(float((a - b).abs().max()) for a, b in zip(*grads))
    for key, e in err.items():
        check(e <= ATTN_TOL["float32"], f"ring attention against {key}: max abs err {e}")
    out["ring_max_abs_err"] = err
    print(f"parallel e: Attention(impl='ring') at sp=1 [{B}, {H}, {N}, {Dh}] f32: max abs err {json.dumps(err)} "
          f"(tolerance {ATTN_TOL['float32']:g})")
    del q, k, v, got, grads
    laps("e ring")

    # g. two gloo ranks on the card: dp=2, fsdp=2 and tp=2 against their single-process steps
    if mesh_job is not None:
        ranks, g_s = mesh_job.result()
        laps("g ranks wait")
        off = ranks[0]["off"]
        out["mesh_ranks"] = {"seconds": g_s, "off": off}
        names = ("single",) + tuple(",".join(f"{k}={v}" for k, v in spec.items()) for spec in MESH_G)
        for name in names:  # every reading printed before any is checked
            per_rank = [rk[name] for rk in ranks]
            out["mesh_ranks"][name] = per_rank
            print(f"parallel g ({smi}): {name} on two gloo ranks on the card, the flagship RL learner at "
                  f"{RL_B} x {RL_T}, two steps, per rank: elements a family "
                  f"{[r['block_numel']['params'] for r in per_rank]} of {per_rank[0]['whole_numel']}, MB between "
                  f"steps {[r['between_mb'] for r in per_rank]}, peak MB {[r['peak_mb'] for r in per_rank]}, "
                  f"launches {per_rank[0]['launches'][0]} a step, attention heads {per_rank[0]['heads']}, the "
                  f"attention kernel off its plain version on the run's first inputs {per_rank[0]['attention_check']['shape']} "
                  f"by {[r['attention_check']['max_abs_err'] for r in per_rank]} (max |plain| "
                  f"{[r['attention_check']['max_abs_plain'] for r in per_rank]}), step ms {[r['ms'] for r in per_rank]} "
                  f"(over gloo, which stages CUDA collectives through the host: no speed figure)")
        print(f"parallel g: gloo collectives on CUDA tensors, each rank: {[rk['gloo_cuda'] for rk in ranks]}; "
              f"ops without a deterministic version: {ranks[0]['nondeterministic_ops']}")
        print(f"parallel g ({smi}): the perf monitor's flops_per_step, implied TFLOP/s and MFU of each rank's own "
              f"step, at its second step's time (gloo-staged: no speed figure), per rank: "
              + "; ".join(f"{name} {[rk[name]['perf'] for rk in ranks]}" for name in ("single", "dp=1,tp=2")))
        print(f"parallel g: off the single-process steps (rank 0's unmeshed learner; 'repeat' is rank 1's) "
              f"in shares of the tests' tolerances (scalars {G_SCALAR_RTOL:g} of max(1, |v|), each step's "
              f"parameters {G_UPDATE_RTOL:g} of its norm, the moments {G_MOMENT_RTOL:g}): {json.dumps(off)}; "
              f"bounds {json.dumps(G_BOUND)}, fsdp=2 against dp=2 {json.dumps(G_BOUND_DP)}")
        for r, rk in enumerate(ranks):
            check(set(rk["gloo_cuda"].values()) == {"ok"}, f"parallel g rank {r}: gloo on CUDA tensors {rk['gloo_cuda']}")
        for name in names:
            split = 2 if "tp" in name else 1
            for r, rec in enumerate(out["mesh_ranks"][name]):
                for step, counts in enumerate(rec["launches"]):
                    launches[f"g {name} rank {r} step {step}"] = counts
                    check(counts == want, f"parallel g {name} rank {r} step {step}: launches {counts}")
                check(rec["heads"] == [2 // split], f"parallel g {name} rank {r}: attention heads {rec['heads']}")
                # ATTN_TOL on the output's scale, as SCATTER_TOL on real sums
                att = rec["attention_check"]
                check(att["shape"][1] == 2 // split
                      and att["max_abs_err"] <= ATTN_TOL["float32"] * max(1.0, att["max_abs_plain"]),
                      f"parallel g {name} rank {r}: the attention kernel at {att['shape']} off its plain version "
                      f"by {att['max_abs_err']} (max |plain| {att['max_abs_plain']})")
                n = rec["block_numel"]
                whole = name in ("single", "dp=2")
                check(n["params"] == n["mu"] == n["nu"] and (n["params"] == rec["whole_numel"] if whole else
                                                             n["params"] * 2 <= rec["whole_numel"] + 10 ** 6),
                      f"parallel g {name} rank {r}: blocks {n} of {rec['whole_numel']}")
        # a tp rank counts its own step: its split products and half the heads, under the whole step's
        single_flops = ranks[0]["single"]["perf"]["flops_per_step"]
        for r, rk in enumerate(ranks):
            tp_flops = rk["dp=1,tp=2"]["perf"]["flops_per_step"]
            check(0 < tp_flops < single_flops and rk["single"]["perf"]["flops_per_step"] == single_flops,
                  f"parallel g tp=2 rank {r}: flops_per_step {tp_flops}, the single-process step's {single_flops}")
        # every meshed run against the single-process step, and fsdp=2 against dp=2, at fixed bounds
        for name, bound in (("dp=2", G_BOUND), ("dp=1,fsdp=2", G_BOUND), ("dp=1,tp=2", G_BOUND),
                            ("dp=1,fsdp=2 against dp=2", G_BOUND_DP)):
            check(all(off[name][k] <= bound[k] for k in G_PARTS), f"parallel g: {name} off by {off[name]}")
        laps("g ranks")

    if executor_job is not None:
        out["executor"] = executor_job.result()
        print(f"parallel f: executor processes {json.dumps(out['executor'])}")
        laps("f executor wait")
    from distar_tpu_torch.parallel.dist import dist_close

    dist_close()
    out["seconds"] = dict(laps)
    print(f"parallel seconds by part: {json.dumps(laps)}")
    total = {name: sum(c.get(name, 0) for c in launches.values()) for name in want}
    return total, out


SC2_BUILD = 75689  # the fake replays' build (4.10.0), the fake install's Versions/Base75689
SC2_EPISODE_LOOPS = 1600  # b.: game_steps_per_episode; the flagship's delays make it a few dozen decisions
SC2_TRAJ_LEN = 8  # b.: the actor's trajectory length
SC2_REPLAYS = 2  # c.: fake replays, each decoded for both players
SC2_REPLAY_ACTIONS = 40  # c.: actions a replay, 10 loops apart
SC2_SL_T = 16  # c.: the SL learner's unroll (batch 2); 2 steps
SC2_SL_ITERS = 2
SC2_PROC_REPLAY_ACTIONS = 132  # d.: the bin's decoder keeps trajectories of 128 steps or more
SC2_PROCESS_TIMEOUT_S = 420
SC2_LOOP_EPISODE = 3000  # d.: rl_train's episodes; a job gives the learner's one iteration its two trajectories


def reference_pth(path, model_overrides, seed):
    """A policy-only model of ``model_overrides`` with ``init_params``
    weights of ``seed``, written as a reference-layout ``.pth`` through
    ``ref_convert.reference_state_dict`` (the inverse of the rules the
    tests use). Returns (the model config, the seeded state dict, seconds)."""
    import torch

    from distar_tpu_torch.model import Model, default_model_config, init_params
    from distar_tpu_torch.model.convert import params_to_flax
    from distar_tpu_torch.model.ref_convert import reference_state_dict
    from distar_tpu_torch.utils import deep_merge_dicts

    t0 = time.perf_counter()
    cfg = deep_merge_dicts(default_model_config(), model_overrides)
    cfg.use_value_network = False
    model = Model(cfg)
    init_params(model, seed)
    sd = reference_state_dict(params_to_flax(model)["params"], cfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return cfg, model.state_dict(), time.perf_counter() - t0


def fake_replay(n_actions, loops_between, seed=0):
    """A fake replay in the form the fake binary plays back
    (tests/test_replay_decoder.py's ``make_replay``): alternating
    build-at-a-point, train and attack-a-unit commands of player 1's units;
    player 1 wins."""
    from distar_tpu_torch.lib import actions as ACT

    gab = {a["name"]: a["general_ability_id"] for a in ACT.ACTIONS}
    actions, loop = [], 10
    for i in range(n_actions):
        unit = [10000 + (i + seed) % 8]
        kind = i % 3
        if kind == 0:
            actions.append((loop, gab["Build_Hatchery_pt"], unit, (20.0 + i % 50, 30.0)))
        elif kind == 1:
            actions.append((loop, gab["Train_Drone_quick"], unit, None))
        else:
            actions.append((loop, gab["Attack_unit"], unit, 20001))
        loop += loops_between
    return {"base_build": SC2_BUILD, "game_version": "4.10.0", "data_version": "FAKE",
            "map_name": "KairosJunction", "game_duration_loops": loop + 50,
            "players": [{"player_id": 1, "race": 2, "mmr": 4800, "apm": 160, "result": 1},
                        {"player_id": 2, "race": 2, "mmr": 4600, "apm": 140, "result": 2}],
            "actions": actions}


def write_replays(root, n, n_actions, loops_between):
    import pickle

    os.makedirs(root, exist_ok=True)
    for i in range(n):
        with open(os.path.join(root, f"r{i}.SC2Replay"), "wb") as f:
            pickle.dump(fake_replay(n_actions, loops_between, seed=i), f)
    return root


def sc2_install(tmp):
    """a. An SC2 install in the script's temp dir whose binary is the port's
    fake (``Versions/Base75689/SC2_x64`` runs ``python3 -m
    distar_tpu_torch.envs.sc2.fake_sc2 "$@"`` with the checkout on
    PYTHONPATH); ``SC2PATH`` points at it, so ``run_configs.get()``,
    ``sc_process`` and the launcher run as they would on a real install."""
    from distar_tpu_torch.envs.sc2.fake_sc2 import write_fake_install

    root = write_fake_install(os.path.join(tmp, "StarCraftII"), REPO)
    os.environ["SC2PATH"] = root
    return root


def sc2_processes(tmp, device):
    """d. The SC2 entry points as processes on the smoke model, over the
    fake install: ``rl_train --type all --env sc2`` for one iteration (both
    agents of the league's job in one game of a fake server process,
    through ``DISTAR_SC2_PORT``, as two real clients share one game; one
    job's episode of SC2_LOOP_EPISODE loops feeds the iteration: a next
    job's clients could not join the fake's game under way, ROADMAP Queue
    3 item 59), ``sl_train --type replay_actor`` (the bin's default decoder,
    launching the install's binary) feeding a ``sl_train --remote`` learner
    of 2 steps through an in-script coordinator, and ``play.py --game_type
    agent_vs_bot --model1`` a smoke-size reference ``.pth``, with
    ``bin/replay_fleet.py`` over the replay actor's replays and
    ``bin/observe.py`` on a live fake game. Runs on a thread beside other
    work; launches nothing in this process."""
    out, t_all = {}, time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1", DISTAR_PERF_AOT="0")

    def run(name, module, argv, extra_env=None):
        log = os.path.join(tmp, f"sc2_{name}.log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, "-u", "-m", module, *argv], cwd=REPO, stdout=f,
                                  stderr=subprocess.STDOUT, env=dict(env, **(extra_env or {})),
                                  timeout=SC2_PROCESS_TIMEOUT_S)
        text = open(log).read()
        check(proc.returncode == 0, f"sc2 {name} exited {proc.returncode}: {text[-3000:]}")
        out[name] = {"seconds": time.perf_counter() - t0}
        return text

    replays = write_replays(os.path.join(tmp, "sc2_proc_replays"), 1, SC2_PROC_REPLAY_ACTIONS, 8)

    def tools():
        """The operator's tools, on a thread of their own beside the rest:
        the replay actor's replay through bin/replay_fleet.py and the bin's
        decoder, and bin/observe.py on a live fake game."""
        text = run("replay_fleet", "distar_tpu_torch.bin.replay_fleet", [
            "--replays", replays, "--workers", "1", "--rss-interval", "1", "--pipeline", "default"])
        report = json.loads(text.strip().splitlines()[-1])
        check(report["decoder"] == "sc2" and report["replays"] == 1 and report["trajectories"] == 2
              and report["failed_decodes"] == 0 and report["frames"] > 0, f"sc2 replay_fleet: {report}")
        out["replay_fleet"].update({k: report[k] for k in ("value", "frames", "trajectories", "wall_s", "rss")})
        out["observe"] = observe_live_game(tmp, env)

    tool_job = Background(tools).start()
    try:
        sc2_chain(run, out, env, replays, device, tmp)
    finally:
        tool_job.result()
    out["seconds"] = time.perf_counter() - t_all
    print(f"sc2 d.: the entry points as processes (smoke model): {json.dumps(out)}")
    return out


def sc2_chain(run, out, env, replays, device, tmp):
    """sc2_processes' entry points, one after another: rl_train --env sc2
    over a fake server, the replay actor into a --remote learner, play.py
    with a smoke .pth."""
    from distar_tpu_torch.bin.sl_train import SMOKE_MODEL
    from distar_tpu_torch.comm import CoordinatorServer

    port = free_port()
    server_log = os.path.join(tmp, "sc2_fake_server.log")
    with open(server_log, "w") as f:
        server = subprocess.Popen([sys.executable, "-m", "distar_tpu_torch.envs.sc2.fake_sc2", "-listen",
                                   "127.0.0.1", "-port", str(port)], cwd=REPO, env=env, stdout=f,
                                  stderr=subprocess.STDOUT)
    try:
        wait_for_line(server, server_log, "fake_sc2 listening", timeout=60)
        text = run("rl_train", "distar_tpu_torch.bin.rl_train", [
            "--type", "all", "--env", "sc2", "--smoke-model", "--device", device.type, "--iters", "1",
            "--env-num", "1", "--traj-len", "2", "--batch-size", "2", "--no-health",
            "--save-path", os.path.join(tmp, "sc2_rl_train"),
            "--config", json.dumps({"env": {"map_name": "KairosJunction", "game_steps_per_episode": SC2_LOOP_EPISODE}})],
            {"DISTAR_SC2_PORT": str(port)})
        check("rl_train done: 1 iters" in text, f"sc2 rl_train: {text[-2000:]}")
        out["rl_train"]["done"] = next(ln for ln in text.splitlines() if ln.startswith("rl_train done"))
    finally:
        server.terminate()
        server.wait(timeout=30)

    # the learner first: a replay actor serves its pushes from its own
    # process, so what it pushed just before it exits is gone unless a
    # learner has pulled it; two epochs of one replay give the learner its
    # two trajectories (one a batch row) well before the actor's last push
    co = CoordinatorServer()
    co.start()
    learner_log = os.path.join(tmp, "sc2_sl_train_remote.log")
    try:
        addr = f"{co.host}:{co.port}"
        t0 = time.perf_counter()
        with open(learner_log, "w") as f:
            learner = subprocess.Popen([
                sys.executable, "-u", "-m", "distar_tpu_torch.bin.sl_train", "--remote", "--coordinator-addr",
                addr, "--device", device.type, "--iters", "2", "--batch-size", "2", "--traj-len", "8",
                "--no-supervise", "--no-health", "--save-path", os.path.join(tmp, "sc2_sl")],
                cwd=REPO, stdout=f, stderr=subprocess.STDOUT, env=env)
        try:
            text = run("replay_actor", "distar_tpu_torch.bin.sl_train", [
                "--type", "replay_actor", "--replays", replays, "--epochs", "2", "--coordinator-addr", addr,
                "--no-health", "--no-supervise"])
            done = next((ln for ln in text.splitlines() if ln.startswith("replay_actor done")), "")
            check(done == "replay_actor done: pushed=4 empty=0 failed=0", f"sc2 replay_actor: {text[-2000:]}")
            wait_ok(learner, learner_log, "sc2 sl_train --remote", timeout=SC2_PROCESS_TIMEOUT_S)
        finally:
            if learner.poll() is None:
                learner.kill()
                learner.wait(timeout=30)
        text = open(learner_log).read()
        done = next((ln for ln in text.splitlines() if ln.startswith("sl_train done")), "")
        check(done.startswith("sl_train done: 2 iters"), f"sc2 sl_train --remote: {text[-2000:]}")
        out["sl_train_remote"] = {"seconds": time.perf_counter() - t0, "done": done}
    finally:
        co.stop()

    pth = os.path.join(tmp, "sc2_smoke.pth")
    reference_pth(pth, SMOKE_MODEL, 1)
    text = run("play", "distar_tpu_torch.bin.play", [
        "--game_type", "agent_vs_bot", "--model1", pth, "--model2", "bot7", "--no-realtime", "--smoke-model",
        "--game-count", "1", "--device", device.type])
    last = text.strip().splitlines()[-1]
    check(last.startswith("games=1 side0_winrate=1.00"), f"sc2 play.py agent_vs_bot --model1 x.pth: {text[-2000:]}")
    out["play"]["result"] = last


def observe_live_game(tmp, env, frames=3):
    """``python -m distar_tpu_torch.bin.observe --endpoint --frames``
    attached to a game under way on a fake server process (the game
    created and joined here, as the first of two connections): ``frames``
    PPM frames and its count line."""
    from distar_tpu_torch.envs.sc2.proto import sc_pb
    from distar_tpu_torch.envs.sc2.remote_controller import RemoteController

    t0 = time.perf_counter()
    port = free_port()
    server_log = os.path.join(tmp, "sc2_observe_server.log")
    with open(server_log, "w") as f:
        server = subprocess.Popen([sys.executable, "-m", "distar_tpu_torch.envs.sc2.fake_sc2", "-listen",
                                   "127.0.0.1", "-port", str(port)], cwd=REPO, env=env, stdout=f,
                                  stderr=subprocess.STDOUT)
    try:
        wait_for_line(server, server_log, "fake_sc2 listening", timeout=60)
        c = RemoteController("127.0.0.1", port, timeout_seconds=30)
        create = sc_pb.RequestCreateGame()
        create.local_map.map_path = "FakeMap.SC2Map"
        create.player_setup.add(type=sc_pb.Participant)
        create.player_setup.add(type=sc_pb.Computer, race=2, difficulty=7)
        c.create_game(create)
        c.join_game(sc_pb.RequestJoinGame(options=sc_pb.InterfaceOptions(raw=True, score=True), race=2))
        d = os.path.join(tmp, "sc2_observe_frames")
        log = os.path.join(tmp, "sc2_observe.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "-m", "distar_tpu_torch.bin.observe", "--endpoint",
                                 f"127.0.0.1:{port}", "--count", str(frames), "--interval", "0.05", "--frames", d],
                                cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT, timeout=120).returncode
        text = open(log).read()
        names = sorted(os.listdir(d)) if os.path.isdir(d) else []
        check(rc == 0 and len(names) == frames and f"{frames} frames written to {d}" in text
              and all(open(os.path.join(d, n), "rb").read(3) == b"P6 " for n in names),
              f"sc2 observe: exit {rc}, frames {names}: {text[-2000:]}")
        c.close()
    finally:
        server.terminate()
        server.wait(timeout=30)
    return {"frames": len(names), "seconds": time.perf_counter() - t0}


def phase_sc2(device, smi, tmp, processes=None):
    """The SC2 side at the flagship (module docstring, phase 15): b. the
    actor on a fake game, c. the two-pass decoder into the SL learner, d.
    (``processes``, a ``Background`` started before the anakin phase, else
    here) the entry points as processes. Returns the launch
    counts of b. and c. and the measurements."""
    import numpy as np
    import torch

    from distar_tpu_torch.actor import Actor, BatchedInference
    from distar_tpu_torch.actor.actor import ACTOR_DEFAULTS
    from distar_tpu_torch.bin import play
    from distar_tpu_torch.comm import Adapter, CoordinatorServer
    from distar_tpu_torch.envs.replay_decoder import ReplayDecoder
    from distar_tpu_torch.envs.sc2.launcher import make_sc2_env
    from distar_tpu_torch.learner import SLLearner
    from distar_tpu_torch.learner.replay_actor import RemoteSLDataloader, ReplayActor
    from distar_tpu_torch.ops import build
    from distar_tpu_torch.ops import kernels as K

    t_phase, laps, out = time.perf_counter(), Laps(), {}
    if not os.environ.get("SC2PATH", "").startswith(tmp):
        sc2_install(tmp)
    if processes is None:
        processes = Background(lambda: sc2_processes(tmp, device)).start()

    # instruments, outside the port: each kernel's first call on each side
    # captured, the flushes and the env's observe + transform timed
    captured, side, flushes, teacher_ms, observe_ms = {}, {"now": None}, [], [], []
    real = {"attention": K.masked_attention, "scatter": K.scatter_add_connection,
            "sample": BatchedInference.sample, "teacher": BatchedInference.teacher_logits}

    def attention(q, k, v, mask):
        key = (side["now"], "masked_attention")
        if side["now"] and key not in captured:
            captured[key] = [t.detach().clone() for t in (q, k, v, mask)]
        return real["attention"](q, k, v, mask)

    def scatter(emb, idx, hw):
        key = (side["now"], "scatter_add_connection")
        if side["now"] and key not in captured:
            captured[key] = (emb.detach().clone(), idx.clone(), hw)
        return real["scatter"](emb, idx, hw)

    def sample(self, prepared, active=None, noise=None):
        t0 = time.perf_counter()
        got = real["sample"](self, prepared, active, noise)  # ends in the device-to-host copy
        flushes.append((time.perf_counter() - t0) * 1e3)
        return got

    def teacher(self, *args, **kw):
        t0 = time.perf_counter()
        got = real["teacher"](self, *args, **kw)  # its logits copied to the host
        teacher_ms.append((time.perf_counter() - t0) * 1e3)
        return got

    def sc2_env():
        env = make_sc2_env({"env": {"map_name": "KairosJunction", "player_ids": ["agent", "bot7"],
                                    "races": ["zerg", "zerg"], "game_steps_per_episode": SC2_EPISODE_LOOPS}})
        observe = env._observe

        def timed_observe(target):
            t0 = time.perf_counter()
            got = observe(target)
            observe_ms.append((time.perf_counter() - t0) * 1e3)
            return got

        env._observe = timed_observe
        return env

    class Pushed:
        def __init__(self):
            self.trajectories = []

        def push(self, token, data, **kw):
            self.trajectories.append((token, data))

        def pull(self, token, block=False):
            return None

    # b.'s weights: the actor's seeded policy as a reference .pth, loaded
    # the way play.py --model1 x.pth loads it
    pth = os.path.join(tmp, "sc2_flagship.pth")
    pth_cfg, seeded, write_s = reference_pth(pth, overlay("pallas", "pallas"), ACTOR_DEFAULTS["actor"]["seed"])
    t0 = time.perf_counter()
    state = play.load_params(pth, pth_cfg)
    out["pth"] = {"write_s": write_s, "load_params_s": time.perf_counter() - t0, "bytes": os.path.getsize(pth),
                  "tensors": len(state)}
    check(set(state) == set(seeded) and all(state[k].dtype == v.dtype and torch.equal(state[k], v)
                                            for k, v in seeded.items()),
          "sc2 b.: the .pth's converted state dict is not the seeded one")
    print(f"sc2 b.: the flagship's seeded policy through a reference .pth, bit for bit: {json.dumps(out['pth'])}")
    del seeded
    laps("b pth")

    launches = {}
    K.masked_attention, K.scatter_add_connection = attention, scatter
    BatchedInference.sample, BatchedInference.teacher_logits = sample, teacher
    try:
        # b. the flagship actor plays one job on a fake game (one fake
        # process launched through run_configs and sc_process, the agent
        # against bot7)
        pushed = Pushed()
        actor = Actor(cfg={"actor": {"env_num": 1, "traj_len": SC2_TRAJ_LEN}}, adapter=pushed,
                      model_cfg=overlay("pallas", "pallas"), env_fn=sc2_env, device=device,
                      player_params={"agent": state})
        job = {"player_ids": ["agent"], "send_data_players": ["agent"], "update_players": [],
               "teacher_player_ids": ["none"], "branch": "eval", "env_info": {"map_name": "KairosJunction"},
               "opponent_id": "bot7"}
        laps("b build")
        K.reset_launch_counts()
        side["now"] = "actor flush"
        t0 = time.perf_counter()
        results = actor.run_job(episodes=1, job=job)
        torch.cuda.synchronize()
        game_s = time.perf_counter() - t0
        side["now"] = None
        launches["actor"] = {n: K.launch_counts[n] for n in build.KERNELS}
        decisions = len(flushes)
        check(len(results) == 1 and results[0]["0"]["opponent_id"] == "bot7"
              and results[0]["game_steps"] >= SC2_EPISODE_LOOPS,
              f"sc2 b.: results {results}")
        check(decisions >= 12 and pushed.trajectories, f"sc2 b.: {decisions} decisions, "
              f"{len(pushed.trajectories)} trajectories pushed")
        # traj_len steps and the next one, which bootstraps the value
        check(all(token == "agenttraj" and len(traj) == SC2_TRAJ_LEN + 1 for token, traj in pushed.trajectories),
              f"sc2 b.: pushed {[(token, len(traj)) for token, traj in pushed.trajectories]}")
        layers, forwards = actor.model_cfg.encoder.entity.layer_num, decisions + len(teacher_ms)
        check(launches["actor"] == {"masked_attention": layers * forwards, "scatter_add_connection": forwards,
                                    "scatter_add_onehot": 0},
              f"sc2 b.: launches {launches['actor']} for {decisions} flushes and {len(teacher_ms)} teacher "
              f"forwards of {layers} layers")
        out["actor"] = {
            "decisions": decisions, "game_loops": results[0]["game_steps"], "seconds": game_s,
            "decisions_per_s": decisions / game_s, "trajectories_pushed": len(pushed.trajectories),
            "flush_ms": {"median": statistics.median(flushes[1:] or flushes), "first": flushes[0]},
            "teacher_forwards": len(teacher_ms),
            "teacher_ms_median": statistics.median(teacher_ms) if teacher_ms else None,
            "env_observe_ms": {"median": statistics.median(observe_ms), "n": len(observe_ms)},
            "winloss": results[0]["0"]["winloss"]}
        print(f"sc2 b. ({smi}): the flagship actor on a fake game (agent vs bot7, {SC2_EPISODE_LOOPS} loops): "
              f"{json.dumps(out['actor'])}, launches {launches['actor']}")
        del actor
        laps("b actor game")

        # c. the two-pass decoder (over the install's binary) into a
        # coordinator, and a flagship SL learner on a RemoteSLDataloader
        replays = write_replays(os.path.join(tmp, "sc2_replays"), SC2_REPLAYS, SC2_REPLAY_ACTIONS, 10)
        co = CoordinatorServer()
        co.start()
        try:
            addr = (co.host, co.port)
            decoded_steps = []

            def decoder():
                dec = ReplayDecoder(cfg={"minimum_action_length": SC2_SL_T})
                run = dec.run

                def counted(path, player):
                    traj = run(path, player)
                    decoded_steps.append(len(traj or ()))
                    return traj

                dec.run = counted
                return dec

            t0 = time.perf_counter()
            replay_actor = ReplayActor(replays, adapter_factory=lambda: Adapter(coordinator_addr=addr),
                                       decoder_factory=decoder, ntasks=1, proc_id=0)
            replay_actor.run()
            decode_s = time.perf_counter() - t0
            check(replay_actor.pushed == 2 * SC2_REPLAYS and replay_actor.failed == 0,
                  f"sc2 c.: pushed {replay_actor.pushed}, empty {replay_actor.empty}, failed {replay_actor.failed}")
            laps("c decode")
            lrn = SLLearner({"learner": {"batch_size": 2, "unroll_len": SC2_SL_T},
                             "model": overlay("pallas", "pallas")}, device=device)
            loader = RemoteSLDataloader(Adapter(coordinator_addr=addr), 2, SC2_SL_T, pull_timeout=60.0)
            batches = [next(loader) for _ in range(SC2_SL_ITERS)]
            laps("c learner build")
            K.reset_launch_counts()
            side["now"] = "sl step"
            logs, step_ms = [], []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logs.append(lrn._train(batch))  # ends in the copy of its scalars to the host
                step_ms.append((time.perf_counter() - t0) * 1e3)
            side["now"] = None
            launches["sl"] = {n: K.launch_counts[n] for n in build.KERNELS}
        finally:
            co.stop()
        check(all(finite(lg) for lg in logs), f"sc2 c.: SL logs {logs}")
        check(launches["sl"] == {"masked_attention": 3 * SC2_SL_ITERS, "scatter_add_connection": SC2_SL_ITERS,
                                 "scatter_add_onehot": 0}, f"sc2 c.: SL launches {launches['sl']}")
        check(int(np.asarray(batches[0]["entity_num"]).max()) > 8, "sc2 c.: the decoded batch holds no units")
        out["decode"] = {"replays": SC2_REPLAYS, "trajectories": replay_actor.pushed,
                         "steps": sum(decoded_steps), "seconds": decode_s,
                         "steps_per_s": sum(decoded_steps) / decode_s}
        out["sl"] = {"batch": [2, SC2_SL_T], "step_ms": step_ms, "losses": [lg["total_loss"] for lg in logs],
                     "action_type_acc": [lg.get("action_type_acc") for lg in logs]}
        print(f"sc2 c. ({smi}): decoded {json.dumps(out['decode'])}; the flagship SL learner on the decoded "
              f"replays: {json.dumps(out['sl'])}, launches {launches['sl']}")
        del lrn, batches
        laps("c sl steps")
    finally:
        K.masked_attention, K.scatter_add_connection = real["attention"], real["scatter"]
        BatchedInference.sample, BatchedInference.teacher_logits = real["sample"], real["teacher"]

    # the path's kernels on their captured inputs against the plain versions
    check({k for k in captured} == {(s, n) for s in ("actor flush", "sl step")
                                     for n in ("masked_attention", "scatter_add_connection")},
          f"sc2: captured {sorted(captured)}")
    out["kernel_max_abs_err"] = path_kernels_against_plain(K, captured, "sc2")
    laps("kernels against plain")
    t0 = time.perf_counter()
    out["processes"] = processes.result()
    out["processes_wait_s"] = time.perf_counter() - t0
    laps("processes wait")
    out["seconds"] = time.perf_counter() - t_phase
    out["laps"] = dict(laps)
    print(f"sc2 seconds by part: {json.dumps(laps)}; waited {out['processes_wait_s']:.1f} s on the processes")
    total = {n: launches["actor"][n] + launches["sl"][n] for n in build.KERNELS}
    return total, out


# ----------------------------------------- phases 12-14, beside 10, 11 and 15
def release_card_cache():
    """What the finished phases left on the card freed: unreachable learners
    (their reference cycles) and the caching allocator's unused blocks,
    which another process on the card could not use otherwise."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phases_beside(device, smi, tmp, batch):
    """Phases 12-14 (the Anakin loop, the league economy, ``parallel/`` on
    the rl phase's ``batch``) and the processes they read, in a process of
    their own (``Spawned``) beside phases 10, 11 and 15, whose loops wait
    on their actors and leave the card idle most of the time: ``--type all
    --env jaxenv`` and the league's processes from its start, the parallel
    phase's executor processes and gloo ranks once the league's are done.
    Each phase reads its launch counts from zero in this process, as it
    would in the script's own. Returns ``{phase: (launches,
    measurements)}`` and the seconds of each."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the learners' default experiment directories apart from phases 10-11's
    os.environ["DISTAR_EXPERIMENTS_ROOT"] = os.path.join(tmp, "experiments_beside")
    out, phase_s, last = {}, {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now

    jaxenv_job = Spawned(jaxenv_smoke_run, device, tmp, tmp=tmp).start()
    league_job = Background(lambda: league_processes(tmp, device)).start()

    # 12. the Anakin loop: the micro-battle world and the flagship on the card
    out["anakin"] = phase_anakin(device, smi, tmp)
    release_card_cache()
    mark("anakin")
    out["anakin"][1]["jaxenv_all"] = jaxenv_job.result()
    mark("jaxenv wait")

    # 13. the league economy: league-run and the arena as processes, a
    # league learner and an arena batch in process. The parallel phase's
    # processes start after the league's: the arena's failover is timed
    # against a bound, and their start-up would load the host beside it
    procs = league_job.result()
    mark("league processes wait")
    executor_job = Background(lambda: executor_processes(tmp, device)).start()
    mesh_job = Background(lambda: mesh_rank_processes(tmp, batch)).start()
    out["league"] = phase_league(device, smi, tmp, out["anakin"][1], procs)
    release_card_cache()
    mark("league")

    # 14. parallel/: a world of one on the rl phase's batch, its executor
    # processes and two gloo ranks on the card beside it
    out["parallel"] = phase_parallel(device, smi, tmp, batch, executor_job, mesh_job)
    mark("parallel")
    out["phase_s"] = phase_s
    return out


def smi_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def main(argv=None) -> int:
    only = None
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        if argv[:1] != ["--only"] or len(argv) != 2 or argv[1] not in ("league", "health", "diagnostics",
                                                                       "parallel", "sc2"):
            print("usage: python3 chip_smoke.py [--only league|health|diagnostics|parallel|sc2]", file=sys.stderr)
            return 2
        only = argv[1]
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from distar_tpu_torch.ops import build, kernels
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port package is not beside this script ({e})", file=sys.stderr)
        return 2

    # whatever a phase's processes leave behind is this process's to stop
    adopted = adopt_orphans()
    t_start = time.perf_counter()
    phase_s, last = {}, [t_start]

    def mark(name):  # the seconds since the previous mark, the script's budget by phase
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")  # the phases' checkpoints and datasets
    # the learners' default experiment directories, out of the checkout
    os.environ["DISTAR_EXPERIMENTS_ROOT"] = os.path.join(tmp, "experiments")
    # the perf monitor's flop count off (learner.perf.aot "auto"), as the
    # test harness has it: a flagship count is seconds of host time on a
    # thread of its own, and the script builds dozens of learners; check h
    # turns it on for the two learners it reads
    os.environ["DISTAR_PERF_AOT"] = "0"
    try:
        # 1. device
        device = torch.device("cuda")
        smi = smi_line()
        print(smi)
        kind = torch.cuda.get_device_name(0)
        print(f"device {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # 2. build
        t0 = time.perf_counter()
        per = build.build()
        print(f"build: {time.perf_counter() - t0:.1f} s wall, per source {per}")
        for name in build.KERNELS:
            for ln in build.build_log(name).splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"ptxas {name}: {ln.strip()}")

        mark("build")

        if only == "league":  # the league phase alone (its launches and checks, no kernels line)
            league_launches, league = phase_league(device, smi, tmp)
            mark("league")
            print(f"phase seconds: {json.dumps(phase_s)}")
            print(f"launches: league {league_launches}")
            print(json.dumps({"league": league_summary(league), "kernel_max_abs_err": league["kernel_max_abs_err"]}))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                      "count": torch.cuda.device_count()}}))
            return 0
        if only == "sc2":  # phase 15 alone, its processes beside its in-process part
            sc2_launches, sc2 = phase_sc2(device, smi, tmp)
            mark("sc2")
            print(f"phase seconds: {json.dumps(phase_s)}")
            print(f"launches: sc2 {sc2_launches}")
            print(json.dumps({"sc2": sc2}))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                      "count": torch.cuda.device_count()}}))
            return 0
        if only == "parallel":  # phase 14 alone, its executor processes beside its in-process part
            from distar_tpu_torch.learner import random_rl_batch

            job = Background(lambda: executor_processes(tmp, device)).start()
            batch = random_rl_batch(RL_B, RL_T, np.random.default_rng(0))
            mesh_job = Background(lambda: mesh_rank_processes(tmp, batch)).start()
            par_launches, par = phase_parallel(device, smi, tmp, batch, job, mesh_job)
            mark("parallel")
            print(f"phase seconds: {json.dumps(phase_s)}")
            print(f"launches: parallel {par_launches}")
            print(json.dumps({"parallel": par}))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                      "count": torch.cuda.device_count()}}))
            return 0
        if only == "diagnostics":  # checks d, e, g and h of phase 9 alone, on learners of their own
            from distar_tpu_torch.learner import random_rl_batch

            batch = random_rl_batch(RL_B, RL_T, np.random.default_rng(0))
            learners = {impl: rl_learner(device, impl, perf={"aot": impl in COUNTED}) for impl in STRINGS}
            ref = tree_reference(learners["pallas"], batch)
            first_logs = steps_agree("rl step", learners, batch)
            flop_counts(learners)
            mark("diagnostics_build")
            diag = phase_diagnostics(device, smi, learners, batch, ref, first_logs)
            mark("diagnostics")
            for name, sec in diag["seconds"].items():
                phase_s[f"{name} (in diagnostics)"] = round(sec, 1)
            print(f"phase seconds: {json.dumps(phase_s)}")
            print(json.dumps({"diagnostics": diag}))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                      "count": torch.cuda.device_count()}}))
            return 0
        if only == "health":  # phase 10's fleet-health drill alone, on phase 10's learner and actor
            loop, args, batch = health_loop(device, tmp)
            mark("health_build")
            health_launches, health = phase_health(device, smi, tmp, loop, args, batch)()
            mark("health")
            health["stepreplay"] = stepreplay_process(tmp, health["blackbox"]["path"])
            mark("stepreplay")
            ab = sampler_ab(loop.learner, batch)
            mark("health_sampler_ab")
            print(f"health drill ({smi}): the learner's step ms by fleet health, none / sampled every 1 s / "
                  f"every {HEALTH_SAMPLE_S:g} s, in turns: {json.dumps(ab)}")
            print(f"phase seconds: {json.dumps(phase_s)}")
            print(f"launches: health drill {health_launches}")
            print(json.dumps({"health": {k: v for k, v in health.items() if k != "step_ms"},
                              "health_step_ms": health["step_ms"]}))
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                      "count": torch.cuda.device_count()}}))
            return 0

        # 3. kernels
        rng = np.random.default_rng(0)
        records = phase_kernels(device, rng)
        for name, rec in records.items():
            print(f"kernel {name}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
                  f"library_ms {rec['library_ms']:.4f} bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})")

        mark("kernels")

        # 4. serve
        launches, flush_ms = phase_serve(device, rng)
        for name in build.KERNELS:
            check(launches.get(name, 0) > 0, f"{name} never launched on the serve path")

        mark("serve")

        # 7. train
        train_launches, train = phase_train(device, rng)
        mark("train")

        # 5-6. the serving process and fleet, in a process of their own
        # (``serve_phases``) beside phase 8 and phase 9's first parts
        release_card_cache()  # the card is shared from here on
        serving = Spawned(serve_phases, device, smi, tmp, tmp=tmp, log=True).start()

        # 8. the SL learner runtime, on a generator of its own
        finish_runtime = phase_sl_runtime(device, np.random.default_rng(8), smi, tmp)
        release_card_cache()
        mark("sl_runtime")

        # 9. RL and distillation. Beside its first parts, which time nothing
        # (the gaps and the strings), phases 5 and 6 and the SL runtime's
        # processes run on, and the rl loop's roles as processes and the
        # replay phase's runs on the smoke model (its roles as processes;
        # the other layouts, sl_train --remote and play.py in a process of
        # their own) run; all of them are joined before it times anything
        loop_roles = Background(lambda: loop_processes(tmp, smi, device)).start()
        replay_jobs = [Background(lambda: replay_processes(tmp, smi, device)).start(),
                       Spawned(replay_smoke_runs, device, tmp, tmp=tmp).start()]
        beside = {}

        def join_beside():
            t0 = time.perf_counter()
            print("phases 5 and 6, in a process of their own beside the rl phase's first parts:")
            beside["serving"] = serving.result()
            beside["runtime"] = finish_runtime()
            beside["roles"] = loop_roles.result()
            for job in replay_jobs:  # read again by the replay phase
                job.result()
            phase_s["processes wait (in rl)"] = round(time.perf_counter() - t0, 1)

        rl_launches, rl = phase_rl(device, smi, rng, beside=join_beside)
        runtime_launches, runtime = beside["runtime"]
        process_launches, process = beside["serving"]["serve_process"]
        fleet_launches, fleet = beside["serving"]["serve_fleet"]
        mark("rl")
        phase_s.update({f"{name} (beside rl)": sec for name, sec in beside["serving"]["phase_s"].items()})
        for name, sec in rl["diagnostics"]["seconds"].items():
            phase_s[f"{name} (in rl)"] = round(sec, 1)

        # 12-14 in a process of their own beside 10, 11 and 15
        # (``phases_beside``); 15's processes over the fake SC2 install
        release_card_cache()
        later = Spawned(phases_beside, device, smi, tmp, rl.pop("batch"), tmp=tmp, log=True).start()
        sc2_install(tmp)
        sc2_job = Background(lambda: sc2_processes(tmp, device)).start()

        # 10. the league-RL loop
        loop_launches, rl_loop = phase_rl_loop(device, smi, tmp, beside["roles"])
        mark("rl_loop")
        phase_s["health (in rl_loop)"] = round(rl_loop["health"]["seconds"], 1)
        # f. the drill's bundle replayed by the port's stepreplay, as a
        # process (it launches nothing in this one) beside the replay phase
        stepreplay_job = Background(lambda: stepreplay_process(tmp, rl_loop["health"]["blackbox"]["path"])).start()

        # 11. the replay store between actors and learner
        release_card_cache()
        replay_launches, replay = phase_replay(device, smi, tmp, rl_loop, replay_jobs)
        mark("replay")
        rl_loop["health"]["stepreplay"] = stepreplay_job.result()
        mark("stepreplay wait")
        phase_s["f: stepreplay (beside replay)"] = round(rl_loop["health"]["stepreplay"]["seconds"], 1)

        # 15. the SC2 side: the flagship actor on a fake game, the decoder
        # into the SL learner; its processes ran beside phases 10 and 11
        release_card_cache()
        sc2_launches, sc2 = phase_sc2(device, smi, tmp, sc2_job)
        mark("sc2")

        print("phases 12-14, in a process of their own beside phases 10, 11 and 15:")
        later = later.result()
        mark("phases 12-14 wait")
        phase_s.update({f"{name} (beside 10, 11 and 15)": sec for name, sec in later["phase_s"].items()})
        anakin_launches, anakin = later["anakin"]
        league_launches, league = later["league"]
        parallel_launches, parallel = later["parallel"]
        anakin["forward_ms_alone"]["rl_loop_flush_alone_median"] = rl_loop["flush_ms"]["alone_median"]
        print(f"anakin: a {ANAKIN_B}-lane forward alone {anakin['forward_ms_alone']['median']:.1f} ms beside "
              f"rl_loop's {LOOP_ENV_NUM}-lane flush alone {rl_loop['flush_ms']['alone_median']:.1f} ms")
        print(f"phase seconds: {json.dumps(phase_s)}")
        print(f"launches: serve {launches}, serve process {process_launches}, serve fleet (gateway A) "
              f"{fleet_launches}, train {train_launches}, sl runtime {runtime_launches}, rl and distill "
              f"{rl_launches}, rl loop (actor and learner) {loop_launches}, health drill (actor and learner) "
              f"{rl_loop['health_launches']}, replay loop (actor and learner) "
              f"{replay_launches}, anakin (windows and learner steps) {anakin_launches}, league (a learner's "
              f"windows with the away seat, its step and an arena batch) {league_launches}, parallel (the "
              f"meshed step and run() through the feeder) {parallel_launches}, sc2 (the actor's flushes on a "
              f"fake game and the SL steps on decoded replays) {sc2_launches}")
        launches = {name: launches[name] + process_launches[name] + fleet_launches[name] + train_launches[name]
                    + runtime_launches[name] + rl_launches[name] + loop_launches[name]
                    + rl_loop["health_launches"][name] + replay_launches[name]
                    + anakin_launches[name] + league_launches[name] + parallel_launches[name]
                    + sc2_launches[name] for name in build.KERNELS}

        # 9. the kernels line; max_abs_err over the serve shapes and the f32
        # SL, RL and student training shapes
        errs = {**train["train_kernel_max_abs_err"],
                **{f"rl {k}": v for k, v in rl["rl_kernel_max_abs_err"].items()},
                **{f"student {k}": v for k, v in rl["student_kernel_max_abs_err"].items()},
                **{f"replay {k}": v for k, v in replay["kernel_max_abs_err"].items()},
                **{f"health {k}": v for k, v in rl_loop["health"]["kernel_max_abs_err"].items()},
                **{f"anakin {k}": v for k, v in anakin["kernel_max_abs_err"].items()},
                **{f"league {k}": v for k, v in league["kernel_max_abs_err"].items()},
                **{f"sc2 {k}": v for k, v in sc2["kernel_max_abs_err"].items()}}
        for name, rec in records.items():
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                err for key, err in errs.items()
                if key.split(" ")[-1].startswith(name) and not key.endswith("bfloat16")])
        line = {"kernels": [
            {"name": name, "route": "cuda", "source": rec["source"], "replaces": rec["replaces"],
             "launches": launches[name], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": rec["library_ms"]}
            for name, rec in records.items()]}
        print(json.dumps({"serve_flush_ms": flush_ms, "serve_process_wire": process["wire"],
                          "serve_fleet_wire": {k: fleet["wire"][k] for k in ("in_process", "tcp", "shm")},
                          "train_step_ms": train["step_ms"],
                          "sl_frames_per_s": train["sl_frames_per_s"], "rl_step_ms": rl["step_ms"],
                          "rl_frames_per_s": rl["rl_frames_per_s"],
                          "distill_step_ms": rl["distill_step_ms"],
                          "sl_runtime_step_ms": {k: runtime["prefetch"][k]["step_ms"]
                                                 for k in ("depth_2", "depth_0")},
                          "sl_runtime_seconds": runtime["seconds"],
                          "rl_loop": {k: rl_loop[k] for k in (
                              "flush_ms", "step_ms", "data_wait_ms", "env_steps_per_s", "frames_made_per_s",
                              "frames_consumed_per_s", "refresh_ms", "push", "peak_memory_gb", "seconds")},
                          "rl_loop_publish_ms": [p["ms"] for p in rl_loop["publish_ms"]],
                          "health": {k: rl_loop["health"][k] for k in (
                              "nan_fire_s", "stall_fire_s", "stall_to_restart_s", "healthz_ms", "dump_s",
                              "bundle_bytes", "ship", "ingest_ms", "store", "seconds")},
                          "health_step_ms": {k: v for k, v in rl_loop["health"]["step_ms"].items() if k != "all"},
                          "health_flush_ms": rl_loop["health"]["flush_ms"],
                          "fleet_health_checks": {"rl_loop_processes": rl_loop["processes"].get("health"),
                                                  "serve_fleet": fleet.get("health")},
                          "replay": {k: replay[k] for k in (
                              "inserts", "samples", "reuse", "spi", "data_wait_ms", "frames_made_per_s",
                              "frames_consumed_per_s", "step_ms", "flush_ms", "insert_ms", "sample_ms",
                              "spill_append_ms", "bytes", "recovery", "peak_memory_gb", "seconds")},
                          "anakin": {k: anakin[k] for k in (
                              "window_s", "env_steps_per_s", "step_ms_in_window", "forward_ms_alone",
                              "learner_step_ms", "step_profile_idle_share", "peak_memory_gb", "seconds")},
                          "anakin_window_idle_share": anakin["steady_window"]["idle_share"],
                          "anakin_head_to_head_s": {k: v["seconds"] for k, v in anakin["head_to_head"].items()},
                          "league": league_summary(league),
                          "parallel": {k: parallel[k] for k in ("group", "step", "ckpt", "feeder",
                                                                 "ring_max_abs_err", "executor", "seconds")},
                          "sc2": {k: sc2[k] for k in ("pth", "actor", "decode", "sl", "processes",
                                                      "processes_wait_s", "seconds")},
                          "phase_seconds": phase_s, "seconds": time.perf_counter() - t_start}))
        print(json.dumps(line))
    except Exception as e:  # every phase failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        for job in SPAWNED:  # none left running but on a failure
            job.kill()
        from multiprocessing import resource_tracker

        left = stop_descendants(keep={resource_tracker._resource_tracker._pid})
        if left:
            print(f"chip_smoke: processes left running, stopped ({'' if adopted else 'not '}their "
                  f"subreaper): {json.dumps(left)}", file=sys.stderr)
        stop_resource_tracker()
        kernels.reset_launch_counts()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
