#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and reported as
success):

1. device   -- require CUDA; print the card's name and power limit
               (nvidia-smi); fp32 everywhere (TF32 off for matmul and
               cuDNN; the engines also pick cuDNN's deterministic
               convolutions).
2. build    -- compile every kernel of the flat round from csrc/ with nvcc
               (one process per source, all started together); print
               ptxas's registers, stack frame and spills of each kernel
               of the sort route of the trimmed means and the medians
               (csrc/trim_sort.cuh), which must keep its keys in
               registers (no stack, no spill); print those of every
               instantiation of the Gram's stage 1 on both routes
               (gram_partials_kernel<KG, VEC>, f32; gram_mma_kernel<WGS,
               N, KS>, bf16 on the tensor cores, where a stack frame or a
               spill fails too), and the HGMMA and HMMA instructions in
               gram_mma_kernel's SASS (cuobjdump -sass; none fails, and a
               toolkit without cuobjdump is said so on the line).
3. kernels  -- hold each CUDA kernel against its plain PyTorch version on
               the card, on seeded numpy cohorts: the main path's shapes
               (mnist_mlp, d = 79,510, n = 100, f = 24), an ALIE cohort of
               identical crafted rows, ragged n and d, n = 1,000 on four
               seeds, and trimmed-mean columns with exact +-dev ties at
               the k-th place.  Distances are also held against an fp64
               Gram; n = 129 and 257 and d = 4,099 cross the Gram's tile
               and slice plan; Krum also runs at c = 0 and c = n - 1; two
               launches of each distance kernel must give the same bits.
               The median and masked kernels are held on the main
               shape with a quarantine mask drawn by the port's own
               fault_masks (f = 10), the Bulyan tail (80 rows, k_delta =
               2f + 1), weighted variants, an all-true mask (bit for bit
               the unmasked kernels), e = 1, e <= k_delta, e = 0, ragged
               n and d and n = 1,000.  The trimmed means and the medians
               are also held at the sort route's edges (n = 32, 33, 64,
               65, 128 and 129, the last on the radix route), each call's
               route printed, two launches bit-equal, and at n = 100 both
               routes run; the medians' two routes must agree bit for bit
               there (the weighted median on dyadic weights).  All six
               are also held at the model family's cohorts: (100,
               117,706) (cifar10_cnn), (100, 272,282) (resnet20) and (10,
               8,972,340) (WRN-40-4), each line with its route or Gram
               plan.  The bf16 operand route of kernels 1 and 2
               (pairwise_distances[bf16], krum_scores[bf16], stage 1 on
               the tensor cores) is held the same way on bf16 cohorts,
               against the plain versions on the same bf16 values and an
               fp64 Gram of them: (100, 79,510) with its identical ALIE
               rows exactly 0 apart, (60, 79,510), (129, 4,099), (257,
               4,099), (257, 4,099) with the ALIE rows at 100..159
               across a tile boundary, (1,000, 79,510), (10, 8,972,340),
               and the tiling's edges n = 1, 2, 16, 17, 63, 64, 65, 128
               by d = 15, 16, 79, 4,099, two launches bit-equal; its
               library time is torch.mm(G, G.T, out_dtype=float32) on the
               bf16 operands plus the plain epilogue (the line says so,
               or that this torch lacks it and cuBLAS's bf16 product
               stood in), its bound at the dense bf16 tensor rate.
               Kernel, plain and library times are CUDA-event medians;
               torch.profiler splits each wrapper's time at the main
               shapes (the trimmed means' also at n = 52, 80 and 1,000,
               the bf16 route's at n = 1,000)
               into the kernels it launches, mixed with the other
               kernels and, for the sort route (and the medians' radix
               route), alone.
4. reference-- three rounds of each defense at a small size on the card,
               without and with faults; each round's aggregate (kernels)
               is held against the plain versions on the CPU on the same
               gradients and mask.
5. main     -- FederatedExperiment.run() on the card at full width:
               mnist_mlp on SYNTH_MNIST at MNIST's 60,000/10,000 sizes,
               n = 100, B = 128, lr 0.1, momentum 0.9, ALIE z = 1.5,
               rounds 0..20: NoDefense, Krum, TrimmedMean, Bulyan and
               Median at f = 24, Krum at f = 0 (mal_prop 0: scored by
               the distance kernel and an exact sort, never the fused
               score kernel), then all five with faults (dropout 0.1,
               straggler 0.1 of delay 2, NaN corruption 0.05) at f = 10,
               whose per-round fault counts must equal a host replay of
               the schedule; then a short run whose bit-scaled corruption
               must trip the divergence watchdog (FloatingPointError,
               state restored and finite).  Launch counters are zeroed
               before and read after each run; every kernel of the run's
               path must have launched, and faulted Krum must not launch
               the fused score kernel.
6. attack   -- the attack layer through make_attacker and run() at the
               same full width: the clipped backdoor ('pattern', z = 1.5,
               f = 24) under all five defenses, sample mode ('-b 1') under
               Krum, the faulted backdoor under TrimmedMean (phase 5's
               faults, f = 10, counts against the host replay), signflip,
               noise, min-max and min-sum under TrimmedMean and min-max
               under Krum (f = 24).  Each run must launch (and avoid) the
               kernels of its ALIE twin in phase 5; backdoor runs must
               print a finite BEFORE line and, after each Test set line,
               a POST line whose ASR lies in [0, 100].  Prints the ASR,
               the median round time, the craft's CUDA-event ms a round
               (shadow training, early-out read, clip), the early-out
               rounds, the noise draw's host ms and min-max's final
               gamma.  Then one backdoor craft and one min-max craft at
               full width on the card against the CPU from the same
               round-0 rows: the backdoor within twice the CPU craft's
               distance from an fp64 craft of the same inputs (the CPU
               test's band), gamma within one bisection step.
7. models   -- the model family through run() at full width, B = 128,
               lr 0.1, momentum 0.9, z = 1.5, with TF32 turned back on
               before each run (the engine must turn it off):
               cifar10_cnn on SYNTH_CIFAR10_HARD at CIFAR-10's 50,000 /
               10,000 sizes, n = 100, rounds 0..20: ALIE at f = 24 under
               all five defenses, the pattern backdoor under TrimmedMean,
               and ALIE faulted (phase 5's faults, f = 10) under
               TrimmedMean and Median, counts against the replay;
               resnet20 on the same set under Krum and Median (f = 24);
               mnist_cnn on phase 5's SYNTH_MNIST under Bulyan (f = 24);
               WRN-40-4 on CIFAR100 (its synthetic stand-in,
               CIFAR100_SYNTH, 50,000 / 10,000, 100 classes) at n = 10
               with augmentation (the auto rule), f = 2 under
               TrimmedMean, Krum and Median and f = 1 under Bulyan.  The
               ResNets run rounds 0..5, evaluated at 0 and 5.  Each run
               must launch its defense's kernels (and none it must avoid)
               and give finite accuracies; it prints its median round
               time, the deliver step's CUDA-event ms a round and its
               peak allocated memory.  Per model, one deliver of 2
               clients x 8 images (2 for the BatchNorm models) on the
               card against the CPU (fp32 with oneDNN on, and fp64; a
               relative-L2 band per client: log-probs and gradients of
               both devices against fp64, the card's gradients against
               the CPU's at twice the band; the BatchNorm models read at
               their seeded initial weights, WRN-40-4's CPU reading with
               oneDNN on and off
               at 1 and N threads printed), whether two
               identical full delivers gave the same bits (printed only),
               one gradient of all n B images without the per-client
               split (timed, as a reference), and one round under
               torch.profiler: its kernel time over its wall time and
               its top kernels.
8. knobs    -- the round's knobs through run() at phase 5's width and
               21 rounds: (a) participation 0.6 at f = 24 (m = 60, m_mal =
               14) under all five defenses, and with dropout 0.1 and NaN
               corruption 0.05 at f = 10 under TrimmedMean, each round's
               cohort equal to a replay from the seed; (b) local_steps 3
               under Krum and TrimmedMean, and Krum with
               server_uses_faded_lr; (c) grad_dtype='bfloat16' under all
               five defenses at f = 24, then faulted (phase 5's faults)
               TrimmedMean and Median; (d) distance_dtype='bfloat16' under
               Krum, Bulyan and faulted Krum; (e) bulyan_batch_select=4
               at f = 24; (f) partition='femnist_style' under Krum; (g) n
               = 1,000, f = 240, bf16 wire and bf16 distances, under Krum
               and TrimmedMean, rounds 0..5.  Each run must launch the
               kernels and routes its dispatch takes (the bf16 routes
               only where the JAX package's does: Krum on a bf16 wire
               launches krum_scores[bf16] and no f32 krum_scores) and none
               it must not; fault counts equal a host replay over the m
               cohort rows; the first three rounds' aggregates hold
               against the plain versions on the CPU on the same wire and
               mask (phase 4's tolerances), and Bulyan's distance matrix
               against the plain version in phase 3's d^2 band; round
               ms, deliver ms (the cohort's host draw, printed apart, is
               outside it) and peak GiB are printed.

9. lifecycle-- the run lifecycle on the card at phase 5's width (mnist_mlp,
               n = 100, rounds 0..20, test_step 5, checkpoint_every 5),
               each run with a RunLogger, a RunJournal and a Checkpointer
               in a fresh temporary run_dir / log_dir: (a) ALIE under Krum
               at f = 24 and (b) ALIE under TrimmedMean with phase 5's
               faults at f = 10, each run uninterrupted, then again
               preempted (GracefulShutdown(preempt_at_round=8): Preempted
               at round 10, an auto-checkpoint of round counter 11, the
               straggler ring in extra_stale for (b)) and resumed from
               Checkpointer.latest() in a third engine, on the card; the
               resumed run's final weights and velocity must equal the
               uninterrupted run's bit for bit (else the first round
               whose weights part is printed), the journal must verify,
               every eval round appear once in the events, the manifest
               say done; (b)'s per-round fault counts over both attempts
               must equal a host replay and run 1's; each run must launch
               its defense's kernel (Krum: krum_scores; faulted
               TrimmedMean: masked_trimmed_mean, no krum_scores).  (c) the
               watchdog with checkpoint_every 2 and a Checkpointer: the
               rollback restores the last auto-checkpoint (round counter
               5), writes it again, and FloatingPointError comes past
               max_rollbacks with a finite state.  (d) the CLI as a
               subprocess: FL_PREEMPT_AT_ROUND=8 exits 75, --resume 0;
               a real SIGTERM after the first Test set line exits 75,
               --resume 0; events valid, journals verified.  Printed,
               not gated: save_auto and resume host ms and bytes for (a),
               (b) and a WRN-40-4 engine, (a)'s median round ms beside
               phase 5's Krum run.
10. async   -- asynchronous buffered rounds (aggregation='async') through
               run() at phase 5's width, rounds 0..20, async_max_staleness
               2 (a ring of depth 3): (a) ALIE at f = 24, k = 64 under
               NoDefense 'none', Krum 'poly', TrimmedMean 'poly' and
               Median 'const'; (b) ALIE at f = 10, k = 50 under Bulyan
               'none' and 'poly'; (c) phase 5's faults at f = 10, k = 50
               under TrimmedMean 'poly', Median 'poly' and Krum 'const';
               (d) backdoor_timed under TrimmedMean 'poly' (f = 24, k =
               64, 50 shadow steps a round).  Each run's 'async' records
               must equal the port's host replay of the schedule ((a),
               (b), (d)), every round deliver 0 or k rows, round 0 of (a)
               deliver none and leave weights and velocity bit-equal
               (the round counter advancing); rounds 0..4 hold the card's
               async step against the same step on the CPU on the card's
               gradients (masks, staleness, counts and the delivered
               matrix bit for bit) and the card's aggregate against the
               plain versions on the CPU (phase 4's tolerances; a weighted
               median's differing columns adjudicated in fp64: each pick
               a lower weighted median within the weight sums' rounding);
               (c)'s fault counts equal a host replay; (d)'s delivered
               timed rows are all fresh; each run launches its kernels
               and no other (kernels 3 and 4 and the fused Krum scores
               never), and the masked sort kernels take the staleness
               weights exactly in the 'poly'/'const' runs (their calls
               counted by spies).  (e) (a)'s Krum 'poly' preempted at
               round 10 with checkpoint_every 5 and resumed, the ring and
               the pool in the checkpoint, bit for bit the whole run.
               Printed: round ms, deliver ms, peak GiB, the step's host
               ms (its schedule draw apart), one more round under
               torch.profiler (kernel time over wall time, top kernels),
               the staleness histogram, save/resume ms and bytes of the
               async state,
               and kernels 5 and 6 with poly weights at (100, 79,510), e
               = 64 (ms, plain ms, bound).
11. defense -- the beyond-reference defenses through run() at full width:
               first the threefry kernel (csrc/threefry_bits.cu, DnC's
               sketch bits; it ports no TPU kernel) at one round's draw,
               (10, 79,510), bit for bit its plain version on the card
               and the host's bits, the sketch the host's choice; then
               (a) mnist_mlp at n = 100, ALIE f = 24, 21 rounds, under
               DnC, GeoMedian, CenteredClip, FLTrust and NormBound; (b)
               min-max and min-sum under DnC; (c) the clipped backdoor
               under NormBound; (d) FLTrust on a bf16 wire; (e) DnC at
               participation 0.6; (f) FLTrust and CenteredClip on
               cifar10_cnn (SYNTH_CIFAR10_HARD 50,000 / 10,000); (g)
               GeoMedian on WRN-40-4 at n = 10 (d = 8,972,340, CIFAR100's
               stand-in, rounds 0..2).  Rounds 0..2 hold the card's
               aggregate against the same function on the CPU over the
               card's wire (bands in checked_new_defense), DnC's sketch
               against the host's choice and its keep sets against the
               CPU's where decisive, FLTrust's trust decisions where the
               fp64 cosine is clear of 0; CenteredClip must launch the
               median kernel once a round, DnC the threefry kernel, the
               other three no kernel.  (h) DnC preempted at round 10 and
               resumed, bit for bit the whole run.  Printed: round ms,
               deliver ms, peak GiB, DnC's draw ms (device and host),
               FLTrust's server-gradient ms, a profiled DnC and FLTrust
               round.
12. traffic -- population & traffic through run() at phase 5's width, 21
               rounds: (a) Krum over 100,000 clients, diurnal amplitude
               0.5; (b) Krum over an unreliable 150 (rate 0.75,
               reliability 0.3-0.6, dwell 2), whose ladder walks remask
               (Krum), fallback (Median) and hold; (c) TrimmedMean with
               phase 5's faults at f = 10; (d) Median with a sybil burst
               window (period 4, width 1); (e) async TrimmedMean 'poly',
               k = 64, with the latency profile; (f) (b) preempted at
               round 10 and resumed.  Each run's 'traffic' events must
               equal the host replay, each round launch exactly the
               kernels of its action (Krum: the distance kernel; the
               fallback Median: the masked median; hold: none), a hold
               round leave weights and velocity bit for bit, rounds 0..2
               hold the aggregates against the CPU as phase 10 does;
               (e)'s records and delays equal the host replay and differ
               from the uniform draw; (f) bit for bit, its stitched
               events the replay's.  Printed: the schedule's host ms a
               round, the actions, arrivals and f_eff.

13. hier   -- the hierarchical two-tier round through run() at phase 5's
               width, batch 32, megabatches of 100 (S = n / 100), mal_prop
               0.24: [hier kernel] lines first, each kernel of the path
               against its plain version at the tier-1 shape (100,
               79,510) and tier 2's (10, 79,510), unmasked and masked
               (alive counts with two dead shards); (a) n = 1,000 (S =
               10, f1 = 24, f2 = 3) under Krum/Krum, Bulyan/TrimmedMean,
               TrimmedMean/Median, Median/Median, NoDefense/NoDefense,
               and Krum/Krum 'concentrated', 6 rounds; (b) faulted
               TrimmedMean/Krum (dropout, NaN corruption, shard-domain
               dropout 0.2 with dwell 2, stragglers at delay 2; 8 rounds
               walking remask, fallback and hold), its 'fault' events and
               actions equal to hier_fault_schedule + plan_tier2_actions,
               then checkpointed after round 3 (the (2, 10, 100, d) ring)
               and resumed bit for bit; (c) Krum/Krum over 100,000
               clients, the slots the card used equal to the host's draw;
               (d) the backdoor under TrimmedMean, 3 rounds, one craft a
               megabatch; (e) Bulyan/Bulyan at n = 10,000 (S = 100, f1 =
               f2 = 24) on 320,000 images, 32 a client, its peak above
               the resting state under 1 GB.  Each round must launch S
               tier-1 calls' and one tier-2 call's kernels (the action's
               under faults) and no other; the first two calls of each
               tier are held against the CPU as phases 10 to 12 do.
               Printed: round ms (host clock and CUDA events), deliver ms
               per megabatch, peak, launches.
14. secagg -- secure aggregation: first the mask kernel
               (csrc/secagg_masks.cu, no TPU kernel's port; ptxas's
               registers, no stack or spill allowed) at (3, 257), (19,
               257), (32, 4,099), (129, 4,099) and (100, 79,510), each
               entry point bit for bit its plain version on the card: the
               net masks (two launches equal, a sample of columns equal to
               the host's threefry, every column summing to 0 mod 2**32),
               the residue and its pair count under all-true, one-dead,
               one-alive and random masks, the unmask pass's recovered
               rows and flag (0 when a dead row's residue is left out);
               ms, plain ms and bound at (100, 79,510) ([secagg kernel]
               lines).  Then, each against its clear twin run in the
               phase, weights and velocity byte-equal: (b) vanilla ALIE
               NoDefense at n = 100, f = 24, 21 rounds, one deltas draw
               and one unmask a round and no residue; (c) with dropout
               0.1, the 'secagg' events equal to the host replay's drops,
               a residue every round (an alive mask); (d) groupwise at n =
               1,000, S = 10, batch 32 under tier-2 NoDefense, Krum and
               Median, S draws and S unmasks a round; (e) groupwise with
               dropout 0.1 and shard-domain dropout 0.2 (dwell 2), 8
               rounds walking the tier-2 ladder, a residue in every group
               a round, preempted after round 4 and resumed, bit for
               bit with its events.  Printed ([secagg] lines): round ms
               beside the clear twin's, the protect stage's CUDA-event
               ms a call (draw, residue, unmask), launches.
15. observe -- the observatories (telemetry, margins, numerics, round
               stats) through run(), each run beside its flags-off twin
               run in the phase: weights and velocity byte-equal, launches
               the twin's plus the margins' anchors (one median kernel a
               round for the trimmed mean's and Bulyan's trim stage, one
               masked median for the masked trimmed mean), every event
               valid (validate_event).  (a) phase 5's cells with all four
               flags: Krum, TrimmedMean, Bulyan and Median at f = 24, Krum
               and TrimmedMean with phase 5's faults at f = 10; rounds
               0..2 hold the card's diagnostics against the plain
               versions on the CPU on the same matrix and mask
               (checked_defense: selections, counts and kept fractions
               bit for bit, scores and margins in phase 3's band,
               diagnostics_vs_cpu), one event of each kind a round, and
               Krum's and Bulyan's crafted rows score bit-equal every
               round (the tie-lock); (b) the science gate's Bulyan margin
               pair (SYNTH_MNIST_HARD 4,000 / 1,000, n = 19, batch 64, z =
               1.5, mal_prop 0.2, 30 rounds, --margins; IID and
               femnist_style at 0.5): margin_tie_rounds and
               colluder_selected_total inside BEHAVIOR_BASELINE.json's
               bands; (c) phase 10's async Krum and TrimmedMean 'poly';
               (d) phase 13's n = 1,000 Krum/Krum and Median/Median with
               --telemetry --margins --numerics (one shard_selection event
               a round, (S, m) stacks), and groupwise secagg under tier-2
               Krum with --telemetry (group_cos_to_mean in every 'secagg'
               event, group_sum_norms bit-equal to the twin's).  Printed
               ([observe] lines): round ms beside the twin's (host clock),
               device ms a round and the extra the diagnostics cost (CUDA
               events, rounds past the checked ones), the card.
16. walls   -- the measured walls and the cost ledger through run(), each
               run beside its flags-off twin run in the phase (weights and
               velocity byte-equal, the twin's launches).  Every capture
               (profile_every; utils/walls.py) is checked: its partition
               exact (stage sums + unattributed = total, the booked events
               the trace's device events, their time the trace's), and
               each kernel of the run booked, through the range around its
               launch (its C entry point) and the launch's correlation, to its
               stage alone.  (a) phase 5's clean cells at f = 24,
               profile_every 1: kernels 1-4 in tier1_aggregate, deliver
               and apply filled, the unattributed device share at most 5
               %; (b) faulted Krum, TrimmedMean and Median (f = 10) and
               async Krum and TrimmedMean 'poly': quarantine filled,
               kernels 1, 5, 6 and 5 w in tier1_aggregate; (c) phase 13's
               n = 1,000, S = 10 Krum/Krum (kernel 2 in both aggregate
               stages), groupwise secagg (S and S u in protect) and DnC (T
               in tier1_aggregate); (d) the cost report on phase 5's Krum
               before its run, captured with profile_every 1: one 'cost'
               and one 'stage_cost' event an entry point, kernel 2's
               counted operations and bytes its table bound's formula,
               the peak from the allocator, the libraries' 'compile'
               facts, the measured stage shares beside the counted ones;
               (e) Krum with profile_every 2
               and the phase timer: the uncaptured interval's round ms
               beside the twin's, the captured intervals apart.  Printed
               ([walls] lines): device ms a round and share by stage,
               the unattributed share, the phase's seconds.
17. hostpath -- the host engines and host streaming through run() on the
               card.  (a) at phase 5's width (f = 24, 21 rounds): Krum
               with distance_impl='host', Bulyan with
               bulyan_selection_impl='host' (the hybrid: kernel 1's
               matrix copied to the host once, the native exact
               selection, kernel 3's trim), with bulyan_trim_impl='host'
               and with bulyan_batch_select 4, TrimmedMean and Median
               with their 'host' impl; each beside its twin on the
               card's route, every call held against the twin's defense
               on the same matrix (Krum's winning row byte-equal,
               Bulyan's picks equal up to ALIE's identical copies or, at
               the first trip where they part, a near-tie by
               utils/numerics.py:adjudicate of fp64 scores, aggregates
               byte-equal where the same kernel trims, the native trims
               within 2 n eps max |g|, Median exact) and the native
               library against its NumPy plain version on the run's
               matrices; must and must-not launch lists (the hybrid
               launches kernels 1 and 3, the full host engines none).
               (b) flat Bulyan at batch 32, f = 24 %, n = 1,000 and
               10,000: the hybrid's split (distance ms by CUDA events,
               the (n, n) copy's ms and MB, the host selection's and the
               native call's ms, the trim's ms) over 2 rounds beside the
               card route's (its second round only within 30 s), the
               selections checked as in (a).  (c) host streaming:
               Krum and TrimmedMean at prefetch 1 and 2, workers 0 and
               1, at full participation and at participation 0.6 with
               femnist_style, and cifar10_cnn with augmentation; each
               run byte-equal to its device-placed twin; the stall per
               get and the round ms beside the twin's.  The native
               library's host times beside NumPy's are
               tools/native_times.py's.
18. campaign-- campaigns and the run readers on the card.  (a) a campaign
               (campaigns/) through the inline executor into a store of
               its own: the five defenses under ALIE and under 'none' at
               phase 5's width (rounds 0..20), phase 5's faulted
               TrimmedMean and Median (f = 10), phase 10's async
               TrimmedMean 'poly', phase 13's hierarchical Bulyan /
               TrimmedMean at n = 1,000 (S = 10, with the forensics
               stream) and Bulyan at f = 25, which must be skipped; the
               build directory a warm copy of _build/.  Each cell's final
               weights byte-equal to its direct twin (phase 5's run, else
               one run here), its must and must-not launches, every
               library it loads a hit and none a miss, the allocator back
               at its rest after each cell; each cell's wall, rounds/s,
               the campaign's overhead between cells.  (b) three of the
               cells as children under the supervisor (one preempted at
               round 10), the build directory passed in their
               environment: each final auto-checkpoint byte-equal to its
               inline twin, each journal clean; a fresh process's
               start-up timed step by step, alone, before.  (c) beside
               (b), in a thread (their processes mostly start): a
               campaign process
               SIGKILLed once two cells are committed, invoked again:
               each cell committed once, no registry stamp twice.  (d)
               the registry's refresh (timed) and report, runs
               list/show/diff/compare/campaign/forensics/async/traffic/
               walls/attribution/margins/numerics/trace/selfcheck over
               (a)'s store, held to the manifests and to an observatory
               run's wall records, cost ledger and margin and numerics
               series kept in memory.  (e) grid.py over the five
               defenses under ALIE, each final accuracy the campaign
               cell's.

Output: one line per check, a {"kernels": [...]} JSON line (launches
summed over phases 5-18), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  The script imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "attacking_federate_learning_tpu_torch"

N_MAIN, F_MAIN, D_MLP = 100, 24, 79_510
# The faulted runs: mal_prop 0.1, so f = 10 and Bulyan's n >= 4f + 3
# holds over the alive rows in most rounds.
F_FAULT = 10
FAULTS_MAIN = dict(dropout=0.1, straggler=0.1, straggler_delay=2,
                   corrupt=0.05, corrupt_mode="nan")
ROUNDS = 21                      # rounds 0..20, evaluated at 0, 10 and 20
TEST_STEP = 10
# The model family's cohorts (phase 7), for phase 3, as (n, d, f, Bulyan's
# f): mnist_cnn, cifar10_cnn and resnet20 at n = 100, f = 24, and WRN-40-4
# at n = 10, f = 2 (f = 1 under Bulyan, which needs n >= 4f + 3).
D_MNIST_CNN, D_CNN, D_RESNET, D_WRN = 21_840, 117_706, 272_282, 8_972_340
MODEL_SHAPES = ((N_MAIN, D_MNIST_CNN, F_MAIN, F_MAIN),
                (N_MAIN, D_CNN, F_MAIN, F_MAIN),
                (N_MAIN, D_RESNET, F_MAIN, F_MAIN), (10, D_WRN, 2, 1))

# Published peaks (NVIDIA data sheets; dense fp32 outside the tensor cores,
# device memory bandwidth, dense bf16 on the tensor cores), keyed by a
# substring of the card's name.  The SXM part is the default.
PEAKS = {"PCIe": (51.2e12, 2.0e12, 756e12), "NVL": (60.0e12, 3.9e12, 835e12),
         "SXM": (67.0e12, 3.35e12, 989e12)}


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cohort(n, d, f, attack, seed, at=0):
    """Seeded (n, d) f32 cohort: honest normals with the f rows from row
    ``at`` on crafted as the attack would (ALIE: identical rows mean -
    1.5 sigma of the honest rows, the tie structure real rounds
    produce)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d), dtype=np.float32)
    if attack == "alie" and f:
        honest = np.concatenate([G[:at], G[at + f:]])
        mu, sigma = honest.mean(0), honest.std(0)
        G[at:at + f] = mu - 1.5 * sigma
    return G


def time_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of one call (after a warm-up
    call), in ms.  The input stays in L2 between calls where it fits, as
    it does on the main path, which reads the gradients it just wrote."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def close(got, want, atol, rtol):
    err = (got.double() - want.double()).abs()
    lim = atol + rtol * want.double().abs()
    return float(err.max()), bool((err <= lim).all())


def rel_err(*pairs):
    """Largest |got - want| / |want| over (got, want) pairs; a nonzero
    error where want is exactly 0 reads as inf."""
    import torch

    worst = 0.0
    for got, want in pairs:
        diff = (got.double() - want.double()).abs()
        rel = torch.where(diff == 0, 0.0, diff / want.double().abs())
        worst = max(worst, float(rel.max()))
    return worst


def kernel_chain(d):
    """A bound on the longest sequential chain of roundings in one Gram
    output of the distance kernels, whatever the split (csrc/gram_tile.cuh,
    ops/distances.py:GramPlan.rounding_chain): an FMA chain of at most 256
    products, then fewer than ceil(d / 256) + 8 partial sums added in a
    fixed order (tests/test_torch_port_gram.py holds the plan to it)."""
    return 256 + -(-d // 256) + 16


def d2_band(sq, chain):
    """Per pair (i, j): how far an fp32 squared distance sq_i + sq_j -
    2 g_i.g_j may stray when its sums run chains of ``chain`` roundings.
    A chain of L roundings of a sum S strays by about eps * sqrt(L) * S
    (rounding errors add up as a random walk); four times that, on the
    scale sq_i + sq_j of the terms."""
    eps = float(np.finfo(np.float32).eps)
    return 4.0 * math.sqrt(chain) * eps * (sq[:, None] + sq[None, :])


def tie_cohort(n, d, seed):
    """(n, d) f32 columns m + dev, where dev is 0 (odd n) and +-j/4 for
    j = 1 .. n // 2, in a random row order per column, and m a random
    integer.  Every |dev| but 0 ties exactly with its opposite, so a k that
    keeps one of a pair keeps the one in the lower row (argsort(stable))
    and any other order changes the mean."""
    rng = np.random.default_rng(seed)
    j = np.arange(1, n // 2 + 1, dtype=np.float32) * 0.25
    dev = np.concatenate([np.zeros(n % 2, np.float32),
                          np.stack([j, -j], 1).ravel()])
    cols = rng.permuted(np.repeat(dev[:, None], d, axis=1), axis=0)
    return (cols + rng.integers(-16, 17, d)).astype(np.float32)


def kernel_split(calls, reps, label):
    """Prints the device time of each CUDA kernel the wrappers launch
    (mean over ``reps`` rounds of ``calls``), from torch.profiler: a
    wrapper may launch more than one kernel (the distance kernels launch
    the Gram's partial tiles, then the epilogue that sums them; Krum then
    one block per row for the selection)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for call in calls:
                call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    for e in rows:
        print(f"[split] {label:14s} {e.key[:60]:60s} calls={e.count} "
              f"mean_us={e.device_time_total / e.count:.1f}", flush=True)
    if not rows:
        print("[split] not measured: the profiler saw no device time",
              flush=True)


def bit_equal(name, label, got, want, failures):
    """Tensors, or tuples of them, equal bit for bit: their bytes compared,
    so NaN matches the same NaN and -0 differs from +0."""
    import torch

    def same_bits(g, w):
        return (g.dtype == w.dtype and g.shape == w.shape
                and torch.equal(g.contiguous().view(torch.uint8),
                                w.contiguous().view(torch.uint8)))

    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    same = all(same_bits(g, w) for g, w in pairs)
    print(f"[kernel] {name:18s} {label:34s} bit-equal={same}", flush=True)
    if not same:
        failures.append(f"{name} {label}: not bit-equal")


def ptxas_entries(log):
    """(mangled kernel name, registers, stack frame bytes, spill store
    bytes, spill load bytes) of each entry function in an nvcc -Xptxas -v
    log."""
    import re

    out, name, frame = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and frame:
            out.append((name, int(m.group(1))) + frame)
            name = None
    return out


# Each library's sort-route kernel: trim_sort_kernel<NP, MASKED, WEIGHTED>
# or median_sort_kernel<NP, MASKED, WEIGHTED>.
SORT_KERNELS = {"trimmed_mean": "trim_sort_kernel",
                "masked_trimmed_mean": "trim_sort_kernel",
                "median": "median_sort_kernel",
                "masked_median": "median_sort_kernel"}


def sort_route_build(failures):
    """Phase 2's report on the sort route: each sort kernel that nvcc
    built, with its registers, stack frame and spills.  A stack frame or
    a spill fails: the keys must stay in registers."""
    import re

    from attacking_federate_learning_tpu_torch.ops import _build

    for name, kernel in SORT_KERNELS.items():
        found = 0
        for entry, regs, frame, stores, loads in ptxas_entries(
                _build.ptxas_log(name)):
            m = re.search(kernel + r"ILi(\d+)ELb([01])ELb([01])", entry)
            if not m:
                continue
            found += 1
            np_, masked, weighted = m.groups()
            ok = frame == stores == loads == 0
            print(f"[build] {name:19s} {kernel}<{np_}, "
                  f"masked={masked}, weighted={weighted}>: {regs} registers, "
                  f"{frame} bytes stack frame, {stores} bytes spill stores, "
                  f"{loads} bytes spill loads ok={ok}", flush=True)
            if not ok:
                failures.append(f"{name} {kernel}<{np_}>: stack "
                                f"frame or spills")
        if not found:
            failures.append(f"{name}: no ptxas report of the sort route")


def tensor_core_count(path):
    """(HGMMA, HMMA) instructions in the SASS of gram_mma_kernel's
    instantiations in the library at ``path`` (cuobjdump -sass), or None
    when the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hg = hm = 0
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "gram_mma_kernel" in line
        elif inside:
            hg += "HGMMA" in line
            hm += re.search(r"\bHMMA\b", line) is not None
    return hg, hm


def gram_route_build(failures):
    """Phase 2's report on the Gram kernels: registers, stack frame and
    spills of each instantiation of the f32 route's stage 1
    (gram_partials_kernel<KG, VEC>, printed) and of the bf16 route's
    (gram_mma_kernel<WGS, N, KS>: a stack frame or a spill fails, its
    accumulators must stay in registers), and the tensor-core
    instructions in the bf16 route's SASS (none fails)."""
    from attacking_federate_learning_tpu_torch.ops import _build

    for name in ("pairwise_distances", "krum_scores"):
        found = 0
        for entry, regs, frame, stores, loads in ptxas_entries(
                _build.ptxas_log(name)):
            m = re.search(r"gram_partials_kernelILi(\d)ELi(\d)EE", entry)
            if m:
                kg, vec = m.groups()
                print(f"[build] {name:19s} gram_partials_kernel<{kg}, "
                      f"{vec}>: {regs} registers, {frame} bytes stack "
                      f"frame, {stores} bytes spill stores, {loads} bytes "
                      f"spill loads", flush=True)
            m = re.search(r"gram_mma_kernelILi(\d)ELi(\d+)ELi(\d)EE",
                          entry)
            if m:
                found += 1
                wgs, cols, ks = m.groups()
                ok = frame == stores == loads == 0
                print(f"[build] {name:19s} gram_mma_kernel<{wgs}, {cols}, "
                      f"{ks}>: {regs} registers, {frame} bytes stack frame, "
                      f"{stores} bytes spill stores, {loads} bytes spill "
                      f"loads ok={ok}", flush=True)
                if not ok:
                    failures.append(f"{name} gram_mma_kernel<{wgs}, "
                                    f"{cols}, {ks}>: stack frame or spills")
        if found != 4:
            failures.append(f"{name}: {found} ptxas reports of "
                            f"gram_mma_kernel, want 4")
        counts = tensor_core_count(_build.library_path(name))
        if counts is None:
            print(f"[build] {name:19s} gram_mma_kernel SASS: not counted, "
                  f"the toolkit has no cuobjdump", flush=True)
            continue
        print(f"[build] {name:19s} gram_mma_kernel SASS: {counts[0]} HGMMA, "
              f"{counts[1]} HMMA", flush=True)
        if counts[0] + counts[1] == 0:
            failures.append(f"{name}: no tensor-core instruction in "
                            f"gram_mma_kernel's SASS")


def route_of(plan):
    return "route=select" if plan.route == "select" else (
        f"route=sort/{plan.padded}")


def gram_plan_of(G):
    import torch

    from attacking_federate_learning_tpu_torch.ops.distances import (
        device_gram_plan
    )

    p = device_gram_plan(G)
    head = f"plan=tiles {p.tiles} x slices {p.slices} of {p.cps} chains, "
    if G.dtype == torch.bfloat16:
        return head + (f"warpgroups {p.warpgroups}, cols {p.cols}, "
                       f"stage_k {p.stage_k}")
    return head + f"kgroups {p.kgroups}"


def mm_f32_out(G):
    """The bf16 route's library yardstick: one cuBLAS call, bf16 operands
    and f32 output, the route's own function (the port never calls it);
    None where this torch has no mm(..., out_dtype) on CUDA."""
    import torch

    try:
        torch.mm(G[:2], G[:2].T, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return None
    return lambda: torch.mm(G, G.T, out_dtype=torch.float32)


def check_kernels(peaks, failures):
    """Phase 3.  Returns the kernels line's entries (main-path shapes)."""
    import torch

    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
        TrimPlan, krum_complement, krum_scores, krum_scores_cost,
        krum_scores_plain, trim_plan, trimmed_mean_cost, trimmed_mean_of,
        trimmed_mean_of_plain
    )
    from attacking_federate_learning_tpu_torch.ops.distances import (
        gram_route, pairwise_distances, pairwise_distances_cost,
        pairwise_distances_plain
    )

    flops_peak, bytes_peak, bf16_peak = peaks
    eps = float(np.finfo(np.float32).eps)
    entries = {}

    def report(name, label, err, rel, tol, ok, ms, plain_ms, lib_ms,
               cost, entry_for=None):
        """Print one check; with ``entry_for = (source, replaces, shape)``
        it is also the kernel's entry in the kernels line.  ``cost`` is
        the kernel's modeled work (the formula beside its wrapper, the
        cost ledger's too); the bf16 routes' operations are bounded at
        the bf16 tensor rate."""
        rate = bf16_peak if cost.unit == "bf16" else flops_peak
        t_b, t_o = cost.bytes / bytes_peak * 1e3, cost.flops / rate * 1e3
        b_ms, b_by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"[kernel] {name:18s} {label:34s} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} "
              f"tol: {tol} ok={ok} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"launches={_build.LAUNCHES[name]}", flush=True)
        if not ok:
            failures.append(f"{name} {label}: max_abs_err {err:.3e}")
        if entry_for:
            source, replaces, shape = entry_for
            entries[name] = {
                "name": name, "route": "cuda",
                "source": f"{PKG}/csrc/{source}",
                "replaces": f"attacking_federate_learning_tpu/{replaces}",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "shape": shape}

    def check_trim(Gt, k, label, reps, entry_for=None, plan=None):
        nt, d = Gt.shape
        label = f"{label} {route_of(plan or trim_plan(nt, d))}"
        got = trimmed_mean_of(Gt, k, plan)
        want = trimmed_mean_of_plain(Gt, k)
        bit_equal("trimmed_mean", f"{label} two launches", got,
                  trimmed_mean_of(Gt, k, plan), failures)
        # Same median, same keys, same stable kept set; only the order of
        # the k-term sum differs: k rounding steps of the largest kept
        # |dev| (2x margin).
        atol = k * eps * 2.0 * float(Gt.abs().max())
        err, ok = close(got, want, atol, 1e-6)
        ms = time_ms(lambda: trimmed_mean_of(Gt, k, plan), reps)
        pms = time_ms(lambda: trimmed_mean_of_plain(Gt, k), reps)
        report("trimmed_mean", label, err, rel_err((got, want)), f"atol {atol:.2e} + rtol 1e-6",
               ok, ms, pms, None, trimmed_mean_cost(nt, d), entry_for)

    def check_krum(G, f, e, label, reps, entry_for):
        n, d = G.shape
        name = gram_route("krum_scores", G)
        comp = krum_complement(n, f)
        got_s, got_r = krum_scores(G, f)
        want_s, want_r = krum_scores_plain(G, f)
        sum_tol = 2.0 * n * eps * want_r.double().abs()
        ok_s = bool(((got_s.double() - want_s.double()).abs()
                     <= 2.0 * e + sum_tol).all())
        ok_r = bool(((got_r.double() - want_r.double()).abs()
                     <= e + sum_tol).all())
        ga, wa = int(torch.argmin(got_s)), int(torch.argmin(want_s))
        ok_w = ga == wa or abs(float(want_s[ga] - want_s[wa])) <= float(
            2.0 * (e[ga] + e[wa]) + sum_tol[ga] + sum_tol[wa])
        err = max(float((got_s - want_s).abs().max()),
                  float((got_r - want_r).abs().max()))
        bit_equal(name, f"{label} c={comp} two launches",
                  (got_s, got_r), krum_scores(G, f), failures)
        ms = time_ms(lambda: krum_scores(G, f), reps)
        pms = time_ms(lambda: krum_scores_plain(G, f), reps)
        report(name, label + f" c={comp}", err,
               rel_err((got_s, want_s), (got_r, want_r)),
               "rowsum e_i + 2n eps rowsum_i, score 2 e_i + 2n eps rowsum_i,"
               " e_i = sum_j min(sqrt b_ij, b_ij / D_ij) of the distance "
               "band b", ok_s and ok_r and ok_w, ms, pms, None,
               krum_scores_cost(n, d, G.dtype == torch.bfloat16),
               entry_for)

    cases = [  # (n, d, f, attack, seed, reps, main-path?, Bulyan's f)
        (N_MAIN, D_MLP, F_MAIN, "alie", 1, 20, True, F_MAIN),
        (N_MAIN, D_MLP, F_MAIN, "none", 2, 5, False, None),
        (13, 79, 3, "alie", 3, 5, False, None),
        (129, D_MLP, 31, "alie", 8, 3, False, None),
        # Phase 8's cohort at participation 0.6: m = 60, m_mal = 14, and
        # Bulyan's (32, d) tail.
        (60, D_MLP, 14, "alie", 10, 5, False, 14),
        (257, 4099, 60, "alie", 9, 3, False, None),
        (1000, D_MLP, 240, "alie", 4, 3, False, None),
    ] + [(1000, D_MLP, 240, "alie", seed, 1, False, None)
         for seed in (5, 6, 7)] + [
        (n, d, f, "alie", 30 + i, 5, False, fb)
        for i, (n, d, f, fb) in enumerate(MODEL_SHAPES)]
    for n, d, f, attack, seed, reps, main, fb in cases:
        G = torch.from_numpy(cohort(n, d, f, attack, seed)).cuda()
        label = f"n={n} d={d} f={f} {attack} seed={seed} {gram_plan_of(G)}"
        # fp64 reference: squared distances from an fp64 Gram.
        G64 = G.double()
        sq64 = (G64 * G64).sum(1)
        ref2 = (sq64[:, None] + sq64[None, :] - 2.0 * (G64 @ G64.T)).clamp(
            min=0.0)
        del G64
        band_k = d2_band(sq64, kernel_chain(d))
        # The plain version's cuBLAS Gram may sum all of d in one chain.
        band = band_k + d2_band(sq64, d)
        crafted = slice(0, f if attack == "alie" else 0)

        # -- pairwise distances ------------------------------------------
        got = pairwise_distances(G)
        want = pairwise_distances_plain(G)
        got2, want2 = got.double() ** 2, want.double() ** 2
        err = float((got - want).abs().max())
        ok = (bool(((got2 - want2).abs() <= band).all())
              and bool(((got2 - ref2).abs() <= band_k).all())
              and bool((got == got.T).all())
              and bool((got.diagonal() == 0).all())
              and bool((got[crafted, crafted] == 0).all()))
        bit_equal("pairwise_distances", label + " two launches", got,
                  pairwise_distances(G), failures)
        ms = time_ms(lambda: pairwise_distances(G), reps)
        pms = time_ms(lambda: pairwise_distances_plain(G), reps)
        lms = time_ms(lambda: torch.cdist(
            G, G, compute_mode="use_mm_for_euclid_dist"), reps)
        report("pairwise_distances", label, err, rel_err((got, want)),
               f"|D^2-plain^2| <= 4(sqrt {kernel_chain(d)} + sqrt {d}) eps "
               f"(sq_i+sq_j), |D^2-fp64| <= 4 sqrt {kernel_chain(d)} eps "
               f"(sq_i+sq_j), identical rows exactly 0", ok, ms, pms, lms,
               pairwise_distances_cost(n, d),
               main and ("pairwise_distances.cu",
                         "ops/pallas_distances.py:92", [n, d]))

        # -- fused Krum scores, at the main c and at c = 0 and n - 1 ------
        # Each distance may stray by e_ij <= min(sqrt(band), band / D):
        # a rowsum by their sum, a score by twice that (rowsum and top-c),
        # plus the rounding of n-term sums in another order.
        e = torch.minimum(band.sqrt(), band / want.double().clamp(
            min=1e-30)).fill_diagonal_(0.0).sum(1)
        for fk, reps_k in ((f, reps), (1, 1), (n, 1)):
            check_krum(G, fk, e, label, reps_k,
                       main and fk == f and ("krum_scores.cu",
                                             "ops/pallas_defense.py:214",
                                             [n, d]))

        # -- trimmed mean -------------------------------------------------
        check_trim(G, n - f - 1, f"n={n} d={d} k={n - f - 1} {attack} "
                   f"seed={seed}", reps,
                   main and ("trimmed_mean.cu", "ops/pallas_defense.py:274",
                             [n, d]))
        if fb is not None:
            # Bulyan's trim tail, at every shape the main paths run it:
            # set_size = n - 2f rows, keep set_size - 2f - 1.
            Gb = G[:n - 2 * fb].contiguous()
            check_trim(Gb, n - 4 * fb - 1,
                       f"n={n - 2 * fb} d={d} k={n - 4 * fb - 1} {attack}",
                       reps)
        if main:
            # The radix route (the route past 128 rows) at the same shape.
            select = TrimPlan("select", 0)
            check_trim(G, n - f - 1, f"n={n} d={d} k={n - f - 1} {attack}",
                       reps, plan=select)
            kernel_split([lambda: pairwise_distances(G),
                          lambda: krum_scores(G, f),
                          lambda: trimmed_mean_of(G, n - f - 1),
                          lambda: trimmed_mean_of(G, n - f - 1, select),
                          lambda: trimmed_mean_of(Gb, n - 4 * f - 1)],
                         reps, f"n={n}, {n - 2 * f}")
            # The sort route alone, as the main path calls it: the input
            # in L2, no other kernel between two calls.
            kernel_split([lambda: trimmed_mean_of(G, n - f - 1)], reps,
                         f"n={n} alone")
            kernel_split([lambda: trimmed_mean_of(Gb, n - 4 * f - 1)], reps,
                         f"n={n - 2 * f} alone")
        if n == 1000 and reps > 1:
            kernel_split([lambda: trimmed_mean_of(G, n - f - 1)], reps,
                         f"n={n}")
        del G, got, want, got2, want2, ref2, band, band_k
        torch.cuda.empty_cache()

    # Exact +-dev ties at the k-th place: only the stable kept set (lower
    # row first) matches, on the sort route (n <= 128) and on the radix
    # route in registers (n <= 256) and in shared memory.
    for n, k in ((13, 4), (64, 7), (100, 30), (128, 63), (300, 101)):
        Gt = torch.from_numpy(tie_cohort(n, 4099, n)).cuda()
        check_trim(Gt, k, f"n={n} d=4099 k={k} +-ties", 3)
    # The sort route's edges: n at and one past a padding (32, 64, 128),
    # and the switch to the radix route past 128.
    for n in (32, 33, 64, 65, 128, 129):
        G = torch.from_numpy(cohort(n, 4099, n // 4, "alie", n)).cuda()
        check_trim(G, n - n // 4 - 1, f"n={n} d=4099 k={n - n // 4 - 1}", 3)
    check_coord_kernels(report, failures)

    # -- the bf16 operand route of kernels 1 and 2 --------------------------
    # The same checks on bf16 cohorts (the ALIE rows identical in bf16
    # too), against the plain versions on the same bf16 values and an fp64
    # Gram of them: the main path's shapes, the tensor-core tiling's edges
    # (n at one instruction's columns and one past, 64 and 65 rows of a
    # warpgroup; d below one k stage, not a multiple of 16), and ALIE rows
    # that straddle a tile boundary (n = 257, rows 100 to 159).
    bf16_cases = [  # (n, d, f, seed, reps, main-path?, crafted from)
        (N_MAIN, D_MLP, F_MAIN, 11, 20, True, 0),
        (60, D_MLP, 14, 16, 5, False, 0),
        (129, 4099, 31, 12, 3, False, 0),
        (257, 4099, 60, 13, 3, False, 0),
        (257, 4099, 60, 17, 3, False, 100),
        (1000, D_MLP, 240, 14, 3, False, 0),
        (10, D_WRN, 2, 15, 3, False, 0),
    ] + [(n, d, n // 4, 50 + i, 1, False, 0)
         for i, (n, d) in enumerate(
             (n, d) for n in (1, 2, 16, 17, 63, 64, 65, 128)
             for d in (15, 16, 79, 4099))]
    mm_missing = False
    for n, d, f, seed, reps, main, at in bf16_cases:
        G = torch.from_numpy(cohort(n, d, f, "alie", seed, at)).cuda()
        G = G.bfloat16()
        label = (f"n={n} d={d} f={f} alie rows {at}..{at + f - 1} bf16 "
                 f"seed={seed} {gram_plan_of(G)}")
        G64 = G.double()
        sq64 = (G64 * G64).sum(1)
        ref2 = (sq64[:, None] + sq64[None, :] - 2.0 * (G64 @ G64.T)).clamp(
            min=0.0)
        del G64
        band_k = d2_band(sq64, kernel_chain(d))
        band = band_k + d2_band(sq64, d)
        crafted = slice(at, at + f)
        got = pairwise_distances(G)
        want = pairwise_distances_plain(G)
        got2, want2 = got.double() ** 2, want.double() ** 2
        err = float((got - want).abs().max())
        ok = (bool(((got2 - want2).abs() <= band).all())
              and bool(((got2 - ref2).abs() <= band_k).all())
              and bool((got == got.T).all())
              and bool((got.diagonal() == 0).all())
              and bool((got[crafted, crafted] == 0).all()))
        name = "pairwise_distances[bf16]"
        bit_equal(name, label + " two launches", got, pairwise_distances(G),
                  failures)
        ms = time_ms(lambda: pairwise_distances(G), reps)
        pms = time_ms(lambda: pairwise_distances_plain(G), reps)
        mm = mm_f32_out(G)
        if mm is None:
            mm_missing = True

            def mm():
                # cuBLAS on the bf16 operands (a bf16 product): a time
                # only, its Gram is rounded to bf16.
                return (G @ G.T).float()

        def library(G=G, mm=mm):
            g = mm()
            sq = g.diagonal()
            D = torch.sqrt((sq[:, None] + sq[None, :] - 2.0 * g).clamp(
                min=0.0))
            return D.fill_diagonal_(0.0)

        lms = time_ms(library, reps)
        report(name, label, err, rel_err((got, want)),
               f"|D^2-plain^2| <= 4(sqrt {kernel_chain(d)} + sqrt {d}) eps "
               f"(sq_i+sq_j), |D^2-fp64| <= 4 sqrt {kernel_chain(d)} eps "
               f"(sq_i+sq_j), identical rows exactly 0", ok, ms, pms, lms,
               pairwise_distances_cost(n, d, bf16=True),
               main and ("pairwise_distances.cu",
                         "ops/pallas_distances.py:92", [n, d]))
        e = torch.minimum(band.sqrt(), band / want.double().clamp(
            min=1e-30)).fill_diagonal_(0.0).sum(1)
        for fk, reps_k in ((max(f, 1), reps), (1, 1), (n, 1)):
            check_krum(G, fk, e, label, reps_k,
                       main and fk == f and ("krum_scores.cu",
                                             "ops/pallas_defense.py:214",
                                             [n, d]))
        if main or n == 1000:
            kernel_split([lambda: pairwise_distances(G),
                          lambda: krum_scores(G, f)], reps,
                         f"n={n} bf16")
        del G, got, want, got2, want2, ref2, band, band_k
        torch.cuda.empty_cache()
    print("[kernel] bf16 library_ms: " + (
        "torch.mm(G, G.T) in bf16, then widened (this torch has no "
        "mm(..., out_dtype) on CUDA), plus the plain epilogue"
        if mm_missing else "torch.mm(G, G.T, out_dtype=torch.float32), "
        "bf16 operands and an f32 Gram, plus the plain epilogue"),
        flush=True)
    return entries


def exact(got, want):
    """(largest |got - want|, whether they are equal): NaN matches NaN
    and equal infinities match; -0 == +0."""
    import torch

    g, w = got.double(), want.double()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    diff = torch.where(same, 0.0, (g - w).abs())
    return float(torch.nan_to_num(diff, nan=math.inf).max()), bool(same.all())


def finite_rel(got, want):
    """rel_err over the entries where the plain version is finite."""
    import torch

    fin = torch.isfinite(want)
    return rel_err((got[fin], want[fin])) if bool(fin.any()) else 0.0


def drawn_mask(n, t, f=F_FAULT):
    """(n,) alive mask of round t of the faulted runs' schedule with f
    malicious rows, drawn by the port's fault_masks: dropped and corrupted
    rows are dead."""
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
    )
    from attacking_federate_learning_tpu_torch.core.faults import (
        fault_key, fault_masks
    )

    cfg = ExperimentConfig(faults=FaultConfig(**FAULTS_MAIN))
    drop, _, corrupt = fault_masks(fault_key(cfg), t, n, f, cfg.faults)
    return ~(drop | corrupt)


def dyadic_weights(n, seed):
    """Random positive weights j / 64, j in 1..256: every sum of them is
    exact in fp32, so the weighted median's selection is the same in any
    summation order."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 257, n) / 64.0).astype(np.float32)


def check_coord_kernels(report, failures):
    """Phase 3 for kernels 4-6: the median, masked trimmed mean and
    masked median against their plain versions.  Medians and the kept
    sets are selections and must be exact; a trimmed mean may differ by
    the k-term sum's order (k rounding steps of the largest alive |g|,
    2x margin; twice that for the weighted mean's two sums)."""
    import torch

    from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
        TrimPlan, masked_cost, masked_median, masked_median_plain,
        masked_trimmed_mean, masked_trimmed_mean_plain, median_cost,
        median_of, median_of_plain, trim_plan, trimmed_mean_of
    )

    eps = float(np.finfo(np.float32).eps)
    quantile_max = 2 ** 24      # torch.quantile refuses larger inputs

    def check_median(G, label, reps, entry_for=None, plan=None):
        n, d = G.shape
        label = f"{label} {route_of(plan or trim_plan(n, d))}"
        got, want = median_of(G, plan), median_of_plain(G)
        bit_equal("median", f"{label} two launches", got,
                  median_of(G, plan), failures)
        err, ok = exact(got, want)
        ms = time_ms(lambda: median_of(G, plan), reps)
        pms = time_ms(lambda: median_of_plain(G), reps)
        lms = None
        if G.numel() <= quantile_max:
            lms = time_ms(lambda: torch.quantile(
                G, 0.5, dim=0, interpolation="midpoint"), reps)
        else:
            label += " library: none (too large)"
        report("median", label, err, finite_rel(got, want), "exact", ok,
               ms, pms, lms, median_cost(n, d), entry_for)
        return got

    def check_mmed(G, mask, w, label, reps, entry_for=None, plan=None):
        n, d = G.shape
        label = f"{label} {route_of(plan or trim_plan(n, d))}"
        got = masked_median(G, mask, w, plan)
        want = masked_median_plain(G, mask, w)
        bit_equal("masked_median", f"{label} two launches", got,
                  masked_median(G, mask, w, plan), failures)
        err, ok = exact(got, want)
        ms = time_ms(lambda: masked_median(G, mask, w, plan), reps)
        pms = time_ms(lambda: masked_median_plain(G, mask, w), reps)
        lms = None
        if w is None and G.numel() <= quantile_max:
            # The library call on the NaN-masked matrix (made once,
            # outside the timing).
            Gn = torch.where(mask[:, None], G, torch.nan)
            lms = time_ms(lambda: torch.nanquantile(
                Gn, 0.5, dim=0, interpolation="midpoint"), reps)
        elif w is None:
            label += " library: none (too large)"
        # The answer reads only the alive rows (and their weights).
        e = int(mask.sum())
        report("masked_median", label, err, finite_rel(got, want),
               "exact" + (" (dyadic weights)" if w is not None else ""),
               ok, ms, pms, lms, masked_cost(n, d, e, w is not None, 1),
               entry_for)
        return got

    def check_mtrim(G, mask, k_delta, w, label, reps, entry_for=None,
                    plan=None):
        n, d = G.shape
        label = f"{label} {route_of(plan or trim_plan(n, d))}"
        got = masked_trimmed_mean(G, mask, k_delta, w, plan)
        want = masked_trimmed_mean_plain(G, mask, k_delta, w)
        bit_equal("masked_trimmed_mean", f"{label} two launches", got,
                  masked_trimmed_mean(G, mask, k_delta, w, plan), failures)
        e = int(mask.sum())
        k = max(e - k_delta, 1)
        scale = float(G[mask].abs().max()) if e else 0.0
        atol = (2.0 if w is not None else 1.0) * k * eps * 2.0 * scale
        nan_ok = bool((torch.isnan(got) == torch.isnan(want)).all())
        fin = ~torch.isnan(want)
        err, ok = close(got[fin], want[fin], atol, 1e-6) if bool(
            fin.any()) else (0.0, True)
        ms = time_ms(lambda: masked_trimmed_mean(G, mask, k_delta, w, plan),
                     reps)
        pms = time_ms(lambda: masked_trimmed_mean_plain(G, mask, k_delta, w),
                      reps)
        report("masked_trimmed_mean", f"{label} e={e} k={k}", err,
               finite_rel(got, want), f"atol {atol:.2e} + rtol 1e-6, NaN "
               f"where plain is NaN", ok and nan_ok, ms, pms, None,
               masked_cost(n, d, e, w is not None, 3), entry_for)

    n, d, f = N_MAIN, D_MLP, F_FAULT
    select = TrimPlan("select", 0)      # the radix route at the same shape
    # -- main shapes ----------------------------------------------------------
    G = torch.from_numpy(cohort(n, d, F_MAIN, "alie", 11)).cuda()
    med = check_median(G, f"n={n} d={d} f={F_MAIN} alie", 20,
                       ("median.cu", "ops/pallas_defense.py:297", [n, d]))
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    bit_equal("masked_median", f"n={n} all-true mask vs median",
              masked_median(G, ones), med, failures)
    # The two routes pick the same keys: the same bits.
    bit_equal("median", f"n={n} sort route vs radix route", med,
              check_median(G, f"n={n} d={d} f={F_MAIN} alie", 20,
                           plan=select), failures)
    kernel_split([lambda: median_of(G)], 20, f"n={n} alone")
    kernel_split([lambda: median_of(G, select)], 20, f"n={n} radix alone")
    G = torch.from_numpy(cohort(n, d, f, "alie", 12)).cuda()
    mask = torch.from_numpy(drawn_mask(n, 3)).cuda()
    w = torch.from_numpy(dyadic_weights(n, 13)).cuda()
    check_mtrim(G, mask, f + 1, None, f"n={n} d={d} f={f} alie", 20,
                ("masked_trimmed_mean.cu", "ops/pallas_defense.py:388",
                 [n, d]))
    label = f"n={n} d={d} f={f} alie e={int(mask.sum())}"
    mmed = check_mmed(G, mask, None, label, 20,
                      ("masked_median.cu", "ops/pallas_defense.py:406",
                       [n, d]))
    bit_equal("masked_median", f"n={n} sort route vs radix route", mmed,
              check_mmed(G, mask, None, label, 20, plan=select), failures)
    check_mtrim(G, mask, f + 1, w, f"n={n} d={d} f={f} weighted", 5)
    wmed = check_mmed(G, mask, w, f"n={n} d={d} f={f} weighted", 5)
    bit_equal("masked_median", f"n={n} weighted sort vs radix route", wmed,
              check_mmed(G, mask, w, f"n={n} d={d} f={f} weighted", 5,
                         plan=select), failures)
    for what, plan in (("alone", None), ("radix alone", select)):
        kernel_split([lambda plan=plan: masked_median(G, mask, None, plan)],
                     20, f"n={n} {what}")
        kernel_split([lambda plan=plan: masked_median(G, mask, w, plan)], 20,
                     f"n={n} w {what}")
    check_mtrim(G, mask, f + 1, None, f"n={n} d={d} f={f} alie", 20,
                plan=select)
    bit_equal("masked_trimmed_mean", f"n={n} all-true mask vs trimmed",
              masked_trimmed_mean(G, ones, f + 1),
              trimmed_mean_of(G, n - f - 1), failures)
    # Bulyan's tail: the n - 2f selected rows, the first e - 2f alive.
    tail = n - 2 * f
    Gs = G[:tail].contiguous()
    sel = torch.from_numpy(drawn_mask(tail, 5)).cuda()
    sel &= torch.cumsum(sel, 0) <= int(mask.sum()) - 2 * f
    check_mtrim(Gs, sel, 2 * f + 1, None, f"n={tail} d={d} Bulyan tail", 20)
    check_mtrim(Gs, sel, 2 * f + 1, w[:tail].contiguous(),
                f"n={tail} d={d} Bulyan tail weighted", 3)
    kernel_split([lambda: median_of(G), lambda: masked_median(G, mask),
                  lambda: masked_trimmed_mean(G, mask, f + 1),
                  lambda: masked_trimmed_mean(G, mask, f + 1, w),
                  lambda: masked_trimmed_mean(G, mask, f + 1, None, select),
                  lambda: masked_trimmed_mean(Gs, sel, 2 * f + 1)], 20,
                 f"n={n}, {tail}")
    kernel_split([lambda: masked_trimmed_mean(G, mask, f + 1)], 20,
                 f"n={n} alone")
    kernel_split([lambda: masked_trimmed_mean(Gs, sel, 2 * f + 1)], 20,
                 f"n={tail} alone")
    # -- degenerate cohorts: e = 1, e <= k_delta, a short Bulyan tail,
    #    e = 0 (+inf medians, NaN trimmed means, as in JAX) -------------------
    for alive, what in ((1, "one alive"), (f, "alive <= k_delta"),
                        (0, "none alive")):
        m = torch.zeros(n, dtype=torch.bool, device="cuda")
        m[torch.randperm(n, generator=torch.Generator().manual_seed(alive))[
            :alive].cuda()] = True
        check_mtrim(G, m, f + 1, None, f"n={n} {what}", 1)
        check_mtrim(G, m, f + 1, w, f"n={n} {what} weighted", 1)
        check_mmed(G, m, None, f"n={n} {what}", 1)
        check_mmed(G, m, w, f"n={n} {what} weighted", 1)
    short = sel & (torch.cumsum(sel, 0) <= 2 * f + 1)
    check_mtrim(Gs, short, 2 * f + 1, None,
                f"n={tail} Bulyan tail < 2f+2 picks", 1)
    del G, Gs
    torch.cuda.empty_cache()
    # -- ragged n and d (registers, 2 slots, shared memory), +-dev ties,
    #    n = 1,000 ----------------------------------------------------------
    for n_r, d_r, f_r, seed in ((13, 79, 2, 21), (33, 1000, 6, 22),
                                (300, 4099, 60, 23), (1000, D_MLP, 100, 24)):
        G = torch.from_numpy(cohort(n_r, d_r, f_r, "alie", seed)).cuda()
        m = torch.from_numpy(drawn_mask(n_r, seed)).cuda()
        wr = torch.from_numpy(dyadic_weights(n_r, seed)).cuda()
        reps = 3 if n_r == 1000 else 1
        check_median(G, f"n={n_r} d={d_r}", reps)
        check_mtrim(G, m, f_r + 1, None, f"n={n_r} d={d_r}", reps)
        check_mtrim(G, m, f_r + 1, wr, f"n={n_r} d={d_r} weighted", 1)
        check_mmed(G, m, None, f"n={n_r} d={d_r}", reps)
        check_mmed(G, m, wr, f"n={n_r} d={d_r} weighted", 1)
        if n_r == 1000:
            kernel_split([lambda: masked_trimmed_mean(G, m, f_r + 1)], reps,
                         f"n={n_r}")
        del G
        torch.cuda.empty_cache()
    for n_t, k in ((13, 4), (64, 7), (100, 30), (128, 63), (300, 101)):
        Gt = torch.from_numpy(tie_cohort(n_t, 4099, n_t)).cuda()
        check_mtrim(Gt, torch.ones(n_t, dtype=torch.bool, device="cuda"),
                    n_t - k, None, f"n={n_t} d=4099 +-ties", 1)
    # The sort route's edges, as for the unmasked kernels, with a drawn
    # mask, weighted too, and the all-true mask bit for bit the unmasked.
    for n_e in (32, 33, 64, 65, 128, 129):
        G = torch.from_numpy(cohort(n_e, 4099, n_e // 4, "alie", n_e)).cuda()
        m = torch.from_numpy(drawn_mask(n_e, n_e)).cuda()
        we = torch.from_numpy(dyadic_weights(n_e, n_e)).cuda()
        k_delta = n_e // 8 + 1
        check_mtrim(G, m, k_delta, None, f"n={n_e} d=4099", 3)
        check_mtrim(G, m, k_delta, we, f"n={n_e} d=4099 weighted", 1)
        ones = torch.ones(n_e, dtype=torch.bool, device="cuda")
        bit_equal("masked_trimmed_mean", f"n={n_e} all-true mask vs trimmed",
                  masked_trimmed_mean(G, ones, k_delta),
                  trimmed_mean_of(G, n_e - k_delta), failures)
        med = check_median(G, f"n={n_e} d=4099", 3)
        check_mmed(G, m, None, f"n={n_e} d=4099", 3)
        check_mmed(G, m, we, f"n={n_e} d=4099 weighted", 1)
        bit_equal("masked_median", f"n={n_e} all-true mask vs median",
                  masked_median(G, ones), med, failures)
    # -- the model family's shapes (phase 7's cohorts) ----------------------
    for i, (n_m, d_m, f_m, _) in enumerate(MODEL_SHAPES):
        G = torch.from_numpy(cohort(n_m, d_m, f_m, "alie", 40 + i)).cuda()
        m = torch.from_numpy(drawn_mask(n_m, i, f_m)).cuda()
        label = f"n={n_m} d={d_m} f={f_m} alie"
        check_median(G, label, 5)
        check_mtrim(G, m, f_m + 1, None, label, 5)
        check_mmed(G, m, None, f"{label} e={int(m.sum())}", 5)
        del G
        torch.cuda.empty_cache()


def check_reference(failures):
    """Phase 4: three rounds of each defense on the card at a small size,
    without and with faults; every round's aggregate is held against the
    plain versions on the CPU, on the same gradients and mask."""
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.core.faults import (
        MASK_AWARE_DEFENSES
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )

    eps = float(np.finfo(np.float32).eps)
    ds = load_dataset(C.SYNTH_MNIST_HARD, seed=0, synth_train=2000,
                      synth_test=500)
    faults = FaultConfig(dropout=0.15, straggler=0.15, straggler_delay=1,
                         corrupt=0.1)
    runs = ([(d, None) for d in MASK_AWARE_DEFENSES]
            + [(d, faults) for d in MASK_AWARE_DEFENSES])
    for defense, fc in runs:
        # Faulted Bulyan at f = 1: at f = 4 its masked tail keeps one value
        # of an often even count, where the two middle values tie about
        # their midpoint and the selection order breaks the tie.
        mal_prop = 0.06 if fc is not None and defense == "Bulyan" else 0.22
        cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=19,
                               mal_prop=mal_prop, batch_size=32, epochs=3,
                               defense=defense, synth_train=2000,
                               synth_test=500, faults=fc)
        exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                  device="cuda")
        inner, errs = exp.defense_fn, []

        def checked(grads, n, f, inner=inner, errs=errs, **kw):
            got = inner(grads, n, f, **kw)
            want = inner(grads.cpu(), n, f,
                         **{k: v.cpu() for k, v in kw.items()})
            # Krum returns a row of the matrix and Median a selected
            # value: they must be the same.  The means sum at most n terms
            # in another order: n rounding steps of the largest |g| (2x
            # margin).
            atol = 0.0 if defense in ("Krum", "Median") else (
                2.0 * n * eps * float(grads.abs().max()))
            err = float((got.cpu() - want).abs().max())
            errs.append((err, atol))
            return got

        exp.defense_fn = checked
        for t in range(cfg.epochs):
            exp.run_round(t)
        ok = (all(e <= a for e, a in errs)
              and bool(torch.isfinite(exp.state.weights).all()))
        worst = max(errs)
        kind = "faulted" if fc is not None else "clean"
        print(f"[reference] {defense:11s} {kind:7s} n=19 f={exp.f} "
              f"{cfg.epochs} rounds, aggregate on the card vs plain on the "
              f"CPU, same gradients: max_abs_err={worst[0]:.3e} "
              f"tol={worst[1]:.2e} ok={ok}", flush=True)
        if not ok:
            failures.append(f"reference {defense} {kind}: {errs}")


def main_config(defense, mal_prop, faults=None, **kw):
    """The full-width configuration of phases 5 and 6."""
    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=N_MAIN,
                            mal_prop=mal_prop, batch_size=128, epochs=ROUNDS,
                            num_std=1.5, learning_rate=0.1, momentum=0.9,
                            defense=defense, test_step=TEST_STEP,
                            synth_train=60_000, synth_test=10_000,
                            faults=faults, **kw)


def eval_rounds(cfg):
    """The rounds run() evaluates: every test_step-th and the last."""
    return sorted(set(range(0, cfg.epochs, cfg.test_step))
                  | {cfg.epochs - 1})


def drive(exp, kernels, banned, failures, label, excluded=None,
          keep_events=False, timer=None):
    """One full-width run of ``exp.run()`` on the card, launch counters
    zeroed just before and read just after.  ``keep_events`` runs it with
    a files-off RunLogger (each event validated as it is recorded) and
    returns the events too; ``timer`` (a PhaseTimer) goes to run().
    Fails the phase when a
    kernel of ``kernels`` did not launch, one of ``banned`` did, the
    weights or an accuracy is not finite, the evaluations are not the
    config's (0/10/20 in phases 5 and 6), or (with faults) the per-round
    fault counts differ from a host replay of the schedule.  Also times
    the deliver step of each round with CUDA events and reads the peak of
    allocated device memory.  Seconds appended to ``excluded`` during a
    round (a check's own work) are taken off that round's time.  Returns
    what the caller prints."""
    import torch

    from attacking_federate_learning_tpu_torch.core.faults import (
        fault_masks
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    fc = exp.faults
    rounds, evals = exp.cfg.epochs, eval_rounds(exp.cfg)
    round_s, deliver_ev = [], []
    grads_fn = exp.compute_grads

    def timed_grads(t, *part, grads_fn=grads_fn, deliver_ev=deliver_ev):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = grads_fn(t, *part)
        b.record()
        deliver_ev.append((a, b))
        return out

    exp.compute_grads = timed_grads
    inner = exp.run_round

    excluded = [] if excluded is None else excluded

    def timed_round(t, inner=inner, round_s=round_s):
        torch.cuda.synchronize()
        skip = len(excluded)
        a = time.perf_counter()
        state = inner(t)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - a - sum(excluded[skip:]))
        return state

    exp.run_round = timed_round
    seam_s = []
    # Async rounds (phase 10) compose the faults inside the buffered
    # round: no inject seam, and quarantine is counted in the 'async'
    # records.
    buffered = exp.async_spec is not None
    if fc is not None and not buffered:
        # The fault seam's host time (schedule draw, pinned copy,
        # launches), with no synchronisation, so the round times
        # above are not perturbed.
        inject = exp.inject_and_quarantine

        def timed_inject(grads, t, inject=inject, seam_s=seam_s):
            a = time.perf_counter()
            out = inject(grads, t)
            seam_s.append(time.perf_counter() - a)
            return out

        exp.inject_and_quarantine = timed_inject
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logger = None
    if keep_events:
        from attacking_federate_learning_tpu_torch.utils.metrics import (
            RunLogger
        )
        logger = RunLogger(exp.cfg, log_dir=None, log=lines.append)
    _build.reset_launches()
    result = (exp.run(logger, timer=timer) if keep_events
              else exp.run(log=lines.append, timer=timer))
    launches = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    accs = dict(zip(result["epochs"], result["accuracies"]))
    finite = (all(math.isfinite(a) for a in accs.values())
              and bool(torch.isfinite(exp.state.weights).all()))
    missing = [k for k in kernels if launches[k] == 0]
    extra = [k for k in banned if launches[k] != 0]
    out = {"result": result, "launches": launches, "accs": accs,
           "finite": finite, "lines": lines,
           "median_ms": 1e3 * statistics.median(round_s),
           "round_ms": [1e3 * x for x in round_s],
           "deliver_ms": statistics.median(a.elapsed_time(b)
                                           for a, b in deliver_ev),
           "peak_gib": peak / 2 ** 30,
           "per_round": {k: launches[k] / rounds for k in launches
                         if launches[k]},
           "acc_txt": "/".join(f"{accs[r]:.2f}" if r in accs else "none"
                               for r in evals),
           "counts_ok": True,
           "events": logger.events if keep_events else None}
    if fc is not None and getattr(exp, "_placement", None) is not None:
        # Hierarchical rounds (phase 13): the per-shard counts, the dead
        # domains and the ladder's actions against the host replay.
        from attacking_federate_learning_tpu_torch.core.faults import (
            hier_fault_schedule, plan_tier2_actions
        )

        rows = hier_fault_schedule(exp._fault_key, 0, rounds,
                                   exp._placement, fc)
        acts = plan_tier2_actions([r["shards_alive"] for r in rows],
                                  exp._tier2_name, exp._tier2_f)
        out["actions"] = acts.tolist()
        out["counts_ok"] = result["faults"] == [
            {**r, "tier2_action": int(a)} for r, a in zip(rows, acts)]
    elif fc is not None:
        # The counts the engine reported, against a host replay of
        # the schedule (NaN corruption is quarantined with dropout).
        want, draw_s = [], []
        for t in range(rounds):
            a = time.perf_counter()
            drop, stale, corrupt = fault_masks(exp._fault_key, t, exp.m,
                                               exp.m_mal, fc)
            draw_s.append(time.perf_counter() - a)
            row = {"round": t, "injected_dropout": int(drop.sum()),
                   "injected_straggler": int(stale.sum()),
                   "injected_corrupt": int(corrupt.sum())}
            if not buffered:
                row["quarantined"] = int(drop.sum() + corrupt.sum())
            want.append(row)
        out["counts_ok"] = result["faults"] == want
        out["draw_ms"] = 1e3 * statistics.median(draw_s)
        if not buffered:
            out["alive"] = [exp.m - r["quarantined"]
                            for r in result["faults"]]
            out["seam_ms"] = 1e3 * statistics.median(seam_s)
    if (missing or extra or not finite or not out["counts_ok"]
            or sorted(accs) != evals):
        failures.append(f"{label}: missing launches {missing}, unexpected "
                        f"launches {extra}, finite={finite}, "
                        f"counts_ok={out['counts_ok']}, "
                        f"evals={sorted(accs)} (want {evals})")
    return out


# Phase 5's final weights by (defense, faulted, mal_prop), on the host.
P5_FINAL = {}


def run_main_path(ds, failures):
    """Phase 5.  Returns launches per kernel summed over the runs, and
    the clean runs' median round ms by defense."""
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import FaultConfig
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    faults = FaultConfig(**FAULTS_MAIN)
    runs = [  # (defense, faults, mal_prop, must launch, must not launch)
        ("NoDefense", None, 0.24, (), ()),
        ("Krum", None, 0.24, ("krum_scores",), ()),
        ("TrimmedMean", None, 0.24, ("trimmed_mean",), ()),
        ("Bulyan", None, 0.24, ("pairwise_distances", "trimmed_mean"), ()),
        ("Median", None, 0.24, ("median",), ()),
        ("NoDefense", faults, 0.1, (), ()),
        ("Krum", faults, 0.1, ("pairwise_distances",), ("krum_scores",)),
        ("TrimmedMean", faults, 0.1, ("masked_trimmed_mean",), ()),
        ("Bulyan", faults, 0.1,
         ("pairwise_distances", "masked_trimmed_mean"), ()),
        ("Median", faults, 0.1, ("masked_median",), ()),
        # f = 0: no complement for the fused kernel to drop.
        ("Krum", None, 0.0, ("pairwise_distances",), ("krum_scores",)),
    ]
    totals = {name: 0 for name in _build.LAUNCHES}
    clean_ms = {}
    P5_FINAL.clear()
    for defense, fc, mal_prop, kernels, banned in runs:
        cfg = main_config(defense, mal_prop, fc)
        exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                  device="cuda")
        assert exp.flat.dim == D_MLP
        assert exp.f == {0.24: F_MAIN, 0.1: F_FAULT, 0.0: 0}[mal_prop]
        kind = "clean" if fc is None else "faulted"
        run = drive(exp, kernels, banned, failures,
                    f"main {defense} {kind}")
        for name, count in run["launches"].items():
            totals[name] += count
        # Phase 18's campaign cells are held to these final weights.
        P5_FINAL[(defense, fc is not None, mal_prop)] = (
            exp.state.weights.detach().cpu().clone())
        beside = ""
        if fc is None:
            clean_ms.setdefault(defense, run["median_ms"])
        else:
            alive = run["alive"]
            beside = (f"clean_median_round_ms={clean_ms[defense]:.3f} "
                      f"seam_host_ms={run['seam_ms']:.3f} "
                      f"schedule_draw_ms={run['draw_ms']:.3f} "
                      f"fault_counts_match_replay={run['counts_ok']} "
                      f"alive_min/max={min(alive)}/{max(alive)} ")
        print(f"[main] {defense:11s} {kind:7s} f={exp.f} acc r0/r10/r20 = "
              f"{run['acc_txt']} % median_round_ms={run['median_ms']:.3f} "
              f"deliver_ms={run['deliver_ms']:.3f} {beside}"
              f"launches={run['launches']} "
              f"per_round={run['per_round']} finite={run['finite']}",
              flush=True)
        for line in run["lines"]:
            if line.startswith("Test set"):
                print(f"[main]   {line}", flush=True)
    check_watchdog(ds, failures)
    return totals, clean_ms


# Phase 6's clean runs: (defense, must launch, must not launch), each the
# ALIE twin's of phase 5 at f = 24.
CLEAN_KERNELS = {
    "NoDefense": ((), ()),
    "Krum": (("krum_scores",), ()),
    "TrimmedMean": (("trimmed_mean",), ()),
    "Bulyan": (("pairwise_distances", "trimmed_mean"), ()),
    "Median": (("median",), ()),
}
# The card-vs-CPU craft tolerances of the CPU tests: the backdoor's
# (tests/test_torch_port_backdoor.py::test_one_craft_matches_jax: two f32
# crafts of the pipeline differ by at most twice the distance of one of
# them from an fp64 craft of the same inputs) and min-max's gamma, one
# bisection step apart at most (tests/test_torch_port_attacks.py).
ROUNDING_BAND = 2.0


def time_crafts(att):
    """Wraps ``att.craft`` in CUDA events (the shadow training, its
    early-out read and the clip); returns the list of (start, end) event
    pairs it fills, one a round."""
    import torch

    craft_ev, craft = [], att.craft

    def timed_craft(g, ctx):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = craft(g, ctx)
        b.record()
        craft_ev.append((a, b))
        return out

    att.craft = timed_craft
    return craft_ev


def backdoor_lines_ok(lines, asr):
    """The BEFORE line first, each Test set line followed by a POST line
    whose ASR is the run's, in [0, 100]; every number finite."""
    num = r"(\d+\.\d+|nan|inf)"
    ok = bool(re.fullmatch(
        rf"\nBEFORE: Test set\. Average loss: {num}, Accuracy: \d+/10000 "
        rf"\({num}%\)", lines[0]))
    ok = ok and "nan" not in lines[0] and "inf" not in lines[0]
    tests = [i for i, s in enumerate(lines) if s.startswith("Test set:")]
    ok = ok and len(tests) == len(asr) == 3
    for i, a in zip(tests, asr):
        post = lines[i + 1] if i + 1 < len(lines) else ""
        ok = (ok and post.startswith("##Test malicious net: [POST] ")
              and math.isfinite(a) and 0.0 <= a <= 100.0
              and post.endswith(f"({a:.2f}%)"))
    return ok


def run_attack_path(ds, failures):
    """Phase 6: the attack layer at full width.  The clipped backdoor
    ('pattern') under every defense, sample mode under Krum, the faulted
    backdoor under TrimmedMean, signflip / noise / min-max / min-sum
    under TrimmedMean and min-max under Krum, then one backdoor and one
    min-max craft on the card against the CPU from the same rows.
    Returns launches per kernel summed over the runs."""
    import torch

    from attacking_federate_learning_tpu_torch.attacks import make_attacker
    from attacking_federate_learning_tpu_torch.config import FaultConfig
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    totals = {name: 0 for name in _build.LAUNCHES}
    faults = FaultConfig(**FAULTS_MAIN)
    runs = ([("backdoor", "pattern", d, None, 0.24) for d in CLEAN_KERNELS]
            + [("backdoor", "1", "Krum", None, 0.24),
               ("backdoor", "pattern", "TrimmedMean", faults, 0.1)]
            + [(a, "No", "TrimmedMean", None, 0.24)
               for a in ("signflip", "noise", "minmax", "minsum")]
            + [("minmax", "No", "Krum", None, 0.24)])
    for attack, bd, defense, fc, mal_prop in runs:
        cfg = main_config(defense, mal_prop, fc, backdoor=bd)
        att = make_attacker(cfg, dataset=ds, name=attack, device="cuda")
        exp = FederatedExperiment(cfg, att, ds, device="cuda")
        assert exp.f == {0.24: F_MAIN, 0.1: F_FAULT}[mal_prop]
        if fc is None:
            kernels, banned = CLEAN_KERNELS[defense]
        else:
            kernels, banned = ("masked_trimmed_mean",), ()
        kind = "clean" if fc is None else "faulted"
        label = f"attack {attack} -b {bd} {defense} {kind}"
        craft_ev, noise_s = [], []
        if attack == "backdoor":
            craft_ev = time_crafts(att)
        elif attack == "noise":
            noise = att.noise

            def timed_noise(rnd, d, *dtype, noise=noise, noise_s=noise_s):
                a = time.perf_counter()
                out = noise(rnd, d, *dtype)
                noise_s.append(time.perf_counter() - a)
                return out

            att.noise = timed_noise
        run = drive(exp, kernels, banned, failures, label)
        for name, count in run["launches"].items():
            totals[name] += count
        beside = ""
        if attack == "backdoor":
            torch.cuda.synchronize()
            craft_ms = statistics.median(a.elapsed_time(b)
                                         for a, b in craft_ev)
            asr = run["result"]["asr"]
            lines_ok = backdoor_lines_ok(run["lines"], asr)
            beside = (f"asr r0/r10/r20 = "
                      f"{'/'.join(f'{a:.2f}' for a in asr)} % "
                      f"craft_ms={craft_ms:.3f} "
                      f"poison={int(att.poison_count)} "
                      f"early_out_rounds={att.early_outs} "
                      f"lines_ok={lines_ok} ")
            if not lines_ok:
                failures.append(f"{label}: BEFORE/Test set/POST lines "
                                f"{run['lines']}")
        elif attack == "noise":
            beside = (f"noise_draw_host_ms="
                      f"{1e3 * statistics.median(noise_s):.3f} ")
        elif attack in ("minmax", "minsum"):
            beside = f"final_gamma={float(att.last_gamma):.7g} "
        if fc is not None:
            beside += (f"seam_host_ms={run['seam_ms']:.3f} "
                       f"fault_counts_match_replay={run['counts_ok']} ")
        print(f"[attack] {attack:8s} -b {bd:7s} {defense:11s} {kind:7s} "
              f"f={exp.f} acc r0/r10/r20 = {run['acc_txt']} % "
              f"median_round_ms={run['median_ms']:.3f} {beside}"
              f"launches={run['launches']} per_round={run['per_round']} "
              f"finite={run['finite']}", flush=True)
        for line in run["lines"]:
            if line.startswith(("Test set", "##Test", "\nBEFORE")):
                print(f"[attack]   {line.strip()}", flush=True)
    check_crafts_on_the_cpu(main_config("TrimmedMean", 0.24,
                                        backdoor="pattern"), ds, failures)
    return totals


# Phase 7's runs: (model, dataset, n, mal_prop, defense, attack, faulted,
# rounds).  cifar10_cnn keeps the 21 rounds of phases 5 and 6; the
# ResNets run rounds 0..5, evaluated at 0 and 5.
MODEL_RUNS = (
    [("cifar10_cnn", "SYNTH_CIFAR10_HARD", N_MAIN, 0.24, d, "alie", False,
      ROUNDS) for d in CLEAN_KERNELS]
    + [("cifar10_cnn", "SYNTH_CIFAR10_HARD", N_MAIN, 0.24, "TrimmedMean",
        "backdoor", False, ROUNDS),
       ("cifar10_cnn", "SYNTH_CIFAR10_HARD", N_MAIN, 0.1, "TrimmedMean",
        "alie", True, ROUNDS),
       ("cifar10_cnn", "SYNTH_CIFAR10_HARD", N_MAIN, 0.1, "Median", "alie",
        True, ROUNDS),
       ("resnet20", "SYNTH_CIFAR10_HARD", N_MAIN, 0.24, "Krum", "alie",
        False, 6),
       ("resnet20", "SYNTH_CIFAR10_HARD", N_MAIN, 0.24, "Median", "alie",
        False, 6),
       ("mnist_cnn", "SYNTH_MNIST", N_MAIN, 0.24, "Bulyan", "alie", False,
        ROUNDS)]
    + [("wideresnet40_4", "CIFAR100", 10, 0.2, d, "alie", False, 6)
       for d in ("TrimmedMean", "Krum", "Median")]
    + [("wideresnet40_4", "CIFAR100", 10, 0.1, "Bulyan", "alie", False, 6)])
MODEL_DIMS = {"cifar10_cnn": D_CNN, "resnet20": D_RESNET,
              "mnist_cnn": D_MNIST_CNN, "wideresnet40_4": D_WRN}
FAULTED_KERNELS = {"TrimmedMean": ("masked_trimmed_mean",),
                   "Median": ("masked_median",)}
# The card-vs-CPU deliver check: two clients of the round-0 batch, their
# log-probabilities and gradients held in relative L2 per client against
# fp64 on the CPU (tests/test_torch_port_models.py).  The log-probs are
# continuous in the rounding, so every model is held to 1e-5 there: a
# TF32 convolution, off by about 1e-3, fails it.  A gradient is not: where
# fp32 rounding puts a pre-ReLU activation on the other side of 0 than
# fp64 does, ReLU's derivative jumps and every gradient upstream moves,
# and with BatchNorm over a client's few images the whole channel's.  So
# the BatchNorm models run at 2 images a client, where resnet20 holds the
# 1e-5 gradient band; WRN-40-4, with several times resnet20's ReLU inputs,
# flips one even there, on the CPU as on the card, and its gradients are
# held to the tests' kink band, 2e-2.  The BatchNorm models' 8-image
# gradient reading, and every model's log-probs with TF32 on, are printed
# beside, not gated.
# Which kinks flip in the CPU's fp32 gradients depends on the CPU's
# convolution path (oneDNN or PyTorch's own), not on its thread count, and
# on the weights, which a ResNet run left different each time while the
# engines let cuDNN pick a backward that does not repeat (they now ask for
# its deterministic algorithms; at some trained weights one kink flips in
# resnet20's 2-image gradient on both devices alike: 6.339e-4 from fp64
# on the card and on the CPU, 6.4e-7 apart, once on an H100).  So the CPU's
# fp32 leg runs on one pinned path, oneDNN on, and both BatchNorm models
# (resnet20, WRN-40-4) are read at their seeded initial weights, which no
# run changes; WRN-40-4's line also prints the CPU's reading on both
# paths at 1 and N threads.  Both devices' gradients are gated against
# fp64 at the band, and the card's against the CPU's at twice it.
DELIVER_IMAGES = {"cifar10_cnn": 8, "mnist_cnn": 8, "resnet20": 2,
                  "wideresnet40_4": 2}
LOGPROB_BAND = 1e-5
GRAD_BAND = {"cifar10_cnn": 1e-5, "mnist_cnn": 1e-5, "resnet20": 1e-5,
             "wideresnet40_4": 2e-2}


def check_deliver(exp, model, failures, weights=None):
    """Two clients' log-probabilities and gradients from the round-0
    batch, on the card and on the CPU in fp32 and fp64 (the same flat
    weights, ``weights`` or else the engine's current ones; cuDNN on one
    side, the CPU's convolutions with oneDNN on the other);
    whether two identical full delivers on the card gave the same bits
    (printed, not gated: cuDNN's backward may be nondeterministic); and
    the time of one gradient of the mean loss over the same n B images
    without the per-client split (BatchNorm then normalizes over all of
    them: a reference for the convolutions' cost, not the same
    function)."""
    import torch
    from torch.func import functional_call, vmap

    from attacking_federate_learning_tpu_torch.core.client import (
        make_loss_fn
    )

    xs0, ys0 = exp.gather_batches(0)
    if exp.augment:
        from attacking_federate_learning_tpu_torch.data.augment import (
            reflect_crop_flip, round_augment_key
        )
        xs0 = reflect_crop_flip(xs0, round_augment_key(exp.cfg.seed, 0))
    w = exp.state.weights if weights is None else weights
    backends = torch.backends

    def log_probs(w_, xs):
        """Each client's log-probabilities, its BatchNorm over its own
        images, as in deliver."""
        params = exp.flat.unflatten(w_)
        return vmap(lambda x: functional_call(exp.model, params, (x,)))(
            xs).reshape(xs.shape[0], -1)

    def readings(fn, images, variants=False):
        """Relative L2 per client (worst of two) of ``fn`` on the card and
        on the CPU in fp32 against fp64, and of the card's against the
        CPU's; with ``variants`` also the CPU's fp32 reading with oneDNN
        on and off at 1 and N threads (a dict)."""
        xs, ys = xs0[:2, :images], ys0[:2, :images]
        # The module's own parameters are never read: functional_call
        # takes the flat weights' views, on the inputs' device.
        card = fn(w, xs, ys).double().cpu()
        mkldnn = backends.mkldnn.enabled
        backends.mkldnn.enabled = True
        try:
            cpu32 = fn(w.cpu(), xs.cpu(), ys.cpu()).double()
            ref = fn(w.cpu().double(), xs.cpu().double(), ys.cpu())
        finally:
            backends.mkldnn.enabled = mkldnn

        def rel(a, b):
            return float(((a - b).norm(dim=1) / ref.norm(dim=1)).max())
        out = (rel(card, ref), rel(cpu32, ref), rel(card, cpu32))
        if not variants:
            return out
        seen = {}
        threads, mkldnn = torch.get_num_threads(), backends.mkldnn.enabled
        try:
            for on in (True, False):
                for t in (threads, 1):
                    backends.mkldnn.enabled = on
                    torch.set_num_threads(t)
                    got = fn(w.cpu(), xs.cpu(), ys.cpu()).double()
                    seen[f"onednn={'on' if on else 'off'},threads={t}"] = (
                        rel(got, ref))
        finally:
            backends.mkldnn.enabled = mkldnn
            torch.set_num_threads(threads)
        return out, seen

    def deliver(w_, xs, ys):
        """The engine's own deliver function, at one local step."""
        return exp._client_update(w_, xs[:, None], ys[:, None], 0.0, 1.0)

    images = DELIVER_IMAGES[model]
    lp = readings(lambda w_, xs, ys: log_probs(w_, xs), images)
    band = GRAD_BAND[model]
    cpu_paths = ""
    if band > LOGPROB_BAND:
        gr, seen = readings(deliver, images, variants=True)
        cpu_paths = ("cpu-fp64 by CPU path " + " ".join(
            f"{k}:{v:.3e}" for k, v in seen.items()) + " (gated: "
            "onednn=on) ")
    else:
        gr = readings(deliver, images)
    at = "trained" if weights is None else "initial"
    ok = (max(lp[:2]) <= LOGPROB_BAND and max(gr[:2]) <= band
          and gr[2] <= 2 * band)
    # What the log-prob band would see of a TF32 deliver: the card's
    # reading with TF32 on for this one call (printed, not gated).
    saved = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
    try:
        tf32 = readings(lambda w_, xs, ys: log_probs(w_, xs), images)[0]
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved
    beside = (f"(not gated: TF32 log-probs card-fp64={tf32:.3e}, over the "
              f"band={tf32 > LOGPROB_BAND}")
    if images != 8:
        b_card, b_cpu, b_both = readings(deliver, 8)
        beside += (f"; gradients at 8 images card-fp64={b_card:.3e} "
                   f"cpu-fp64={b_cpu:.3e} card-cpu={b_both:.3e}")
    beside += ") "
    del xs0, ys0
    g0 = exp.compute_grads(1)
    same = bool(torch.equal(g0, exp.compute_grads(1)))
    del g0
    xs, ys = exp.gather_batches(1)
    xs, ys = xs.reshape((-1,) + xs.shape[2:]), ys.reshape(-1)
    batched = torch.func.grad(make_loss_fn(exp.model, exp.flat))
    batched_ms = time_ms(lambda: batched(w, xs, ys), 3)
    print(f"[model] {model:14s} deliver card vs CPU, 2 clients x {images} "
          f"images, rel_l2: log-probs card-fp64={lp[0]:.3e} cpu-fp64="
          f"{lp[1]:.3e} card-cpu={lp[2]:.3e} band={LOGPROB_BAND:.0e}; "
          f"gradients card-fp64={gr[0]:.3e} cpu-fp64={gr[1]:.3e} "
          f"card-cpu={gr[2]:.3e} band={band:.0e} (card-cpu "
          f"{2 * band:.0e}) at {at} weights; ok={ok} {cpu_paths}{beside}"
          f"two_full_delivers_bit_equal={same} "
          f"one_grad_of_all_{xs.shape[0]}_images_ms={batched_ms:.3f}",
          flush=True)
    if not ok:
        failures.append(f"{model} deliver card vs CPU at {images} images: "
                        f"log-probs {lp}, gradients {gr}")


def profile_round(exp, model, top=5, tag="model"):
    """One more round of ``exp`` under torch.profiler: its kernel time
    summed over the round's wall time (the profiler's own host cost in
    the wall time) and the kernels that took the most of it.  Under 1 the
    device idled for at least the rest; cuDNN may run kernels
    concurrently, so over 1 says they overlapped, not that the device
    never idled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a = time.perf_counter()
        exp.run_round(int(exp.state.round))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - a)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_time_total > 0),
                  key=lambda e: -e.device_time_total)
    if not rows:
        print(f"[{tag}] {model:14s} profile: not measured, the profiler saw "
              f"no device time", flush=True)
        return
    busy = sum(e.device_time_total for e in rows)
    print(f"[{tag}] {model:14s} profile of one round: wall_ms="
          f"{wall_us / 1e3:.3f} kernel_ms={busy / 1e3:.3f} kernel_over_wall="
          f"{busy / wall_us:.3f} kernels={len(rows)} launches="
          f"{sum(e.count for e in rows)}", flush=True)
    for e in rows[:top]:
        print(f"[{tag}]   {e.device_time_total / busy:6.1%} "
              f"calls={e.count:5d} {e.key[:90]}", flush=True)


def run_model_path(ds_mnist, failures):
    """Phase 7: the model family through run() at full width.  Returns
    launches per kernel summed over the runs."""
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import make_attacker
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    totals = {name: 0 for name in _build.LAUNCHES}
    sets = {"SYNTH_MNIST": ds_mnist}
    checked = set()
    for (model, dataset, n, mal_prop, defense, attack, faulted,
         rounds) in MODEL_RUNS:
        if dataset not in sets:
            t0 = time.perf_counter()
            sets[dataset] = load_dataset(dataset, seed=0, synth_train=50_000,
                                         synth_test=10_000)
            ds = sets[dataset]
            print(f"[model] {dataset} -> {ds.name} {len(ds.train_y)}/"
                  f"{len(ds.test_y)} {ds.train_x.shape[1:]} "
                  f"{ds.num_classes} classes made in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        ds = sets[dataset]
        cfg = ExperimentConfig(
            dataset=dataset, model=model, users_count=n, mal_prop=mal_prop,
            batch_size=128, epochs=rounds, num_std=1.5, learning_rate=0.1,
            momentum=0.9, defense=defense,
            test_step=TEST_STEP if rounds == ROUNDS else rounds - 1,
            synth_train=50_000, synth_test=10_000,
            backdoor="pattern" if attack == "backdoor" else False,
            faults=FaultConfig(**FAULTS_MAIN) if faulted else None)
        # The engine, not its caller, keeps the card in IEEE fp32.
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        exp = FederatedExperiment(cfg, make_attacker(cfg, ds, name=attack,
                                                     device="cuda"),
                                  ds, device="cuda")
        fp32 = not (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
        if not fp32 or exp.flat.dim != MODEL_DIMS[model] or (
                exp.augment != (dataset == C.CIFAR100)):
            failures.append(f"{model}: fp32={fp32} d={exp.flat.dim} "
                            f"augment={exp.augment}")
        kernels, banned = (FAULTED_KERNELS[defense], ()) if faulted else (
            CLEAN_KERNELS[defense])
        kind = "faulted" if faulted else "clean"
        label = f"model {model} {attack} {defense} {kind}"
        # The BatchNorm models' deliver is read at their seeded initial
        # weights: a run leaves their trained weights different each time.
        w_init = (exp.state.weights.clone() if model not in checked
                  and getattr(exp.model, "batch_stats", False) else None)
        if attack == "backdoor":
            craft_ev = time_crafts(exp.attacker)
        run = drive(exp, kernels, banned, failures, label)
        for name, count in run["launches"].items():
            totals[name] += count
        beside = ""
        if attack == "backdoor":
            torch.cuda.synchronize()
            asr = run["result"]["asr"]
            craft_ms = [a.elapsed_time(b) for a, b in craft_ev]
            beside = (f"asr {'/'.join(f'{a:.2f}' for a in asr)} % "
                      f"craft_ms median/max={statistics.median(craft_ms):.3f}"
                      f"/{max(craft_ms):.3f} "
                      f"poison={int(exp.attacker.poison_count)} "
                      f"early_out_rounds={exp.attacker.early_outs} ")
            if not backdoor_lines_ok(run["lines"], asr):
                failures.append(f"{label}: BEFORE/Test set/POST lines "
                                f"{run['lines']}")
        if faulted:
            beside += (f"fault_counts_match_replay={run['counts_ok']} "
                       f"alive_min/max={min(run['alive'])}/"
                       f"{max(run['alive'])} ")
        evals = "/".join(f"r{r}" for r in eval_rounds(cfg))
        print(f"[model] {model:14s} {dataset:18s} n={n} f={exp.f} "
              f"{attack:8s} {defense:11s} {kind:7s} d={exp.flat.dim} "
              f"augment={exp.augment} acc {evals} = {run['acc_txt']} % "
              f"median_round_ms={run['median_ms']:.3f} "
              f"deliver_ms={run['deliver_ms']:.3f} "
              f"peak_GiB={run['peak_gib']:.2f} {beside}"
              f"launches={run['launches']} per_round={run['per_round']} "
              f"finite={run['finite']}", flush=True)
        for line in run["lines"]:
            if line.startswith(("Test set", "##Test", "\nBEFORE")):
                print(f"[model]   {line.strip()}", flush=True)
        if model not in checked:
            checked.add(model)
            check_deliver(exp, model, failures, w_init)
            profile_round(exp, model)
        # The timing wrappers hold the experiment in a reference cycle:
        # collect it, so that the next run's peak is its own.
        del exp, run, w_init
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def check_crafts_on_the_cpu(cfg, ds, failures):
    """One backdoor craft and one min-max craft at full width, on the
    card and on the CPU from the same f = 24 rows of a real round: round
    0 of ``cfg``, where about half the backdoor's coordinates fall inside
    its clip envelope (by round 20 nearly all sit at a bound)."""
    import torch

    from attacking_federate_learning_tpu_torch.attacks import (
        AttackContext, MinMaxAttack, NoAttack, cohort_stats
    )
    from attacking_federate_learning_tpu_torch.attacks.backdoor import (
        BackdoorAttack
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )

    t = 0
    exp = FederatedExperiment(cfg, NoAttack(), ds, device="cuda")
    rows = exp.compute_grads(t)[:F_MAIN].clone()
    ctx = exp.attack_context(t)
    cpu_ctx = AttackContext(ctx.original_params.cpu(),
                            ctx.learning_rate.cpu(), t)
    card = BackdoorAttack(exp.cfg, ds, device="cuda")
    host = BackdoorAttack(exp.cfg, ds, device="cpu")
    exact = BackdoorAttack(exp.cfg, ds, device="cpu")
    # The same pipeline in fp64 on the CPU: the poison set, the rows and
    # the context widened, so every step of the shadow training rounds
    # at fp64.
    exact.poison_x = exact.poison_x.double()
    exact.poison_mask = exact.poison_mask.double()
    exact._count = exact._count.double()
    got = card.craft(rows, ctx).cpu()
    want = host.craft(rows.cpu(), cpu_ctx)
    ref = exact.craft(rows.cpu().double(), AttackContext(
        cpu_ctx.original_params.double(), cpu_ctx.learning_rate.double(),
        t))
    err = float((got - want).abs().max())
    cpu64 = float((want.double() - ref).abs().max())
    card64 = float((got.double() - ref).abs().max())
    tol = ROUNDING_BAND * cpu64
    mean, sd = cohort_stats(rows.cpu())
    lo, hi = mean - 1.5 * sd, mean + 1.5 * sd
    share = float(((want <= lo) | (want >= hi)).float().mean())
    ok = (err <= tol and card.early_outs == host.early_outs
          and bool(torch.isfinite(got).all()))
    print(f"[attack] backdoor craft card vs CPU, f={F_MAIN} d={exp.flat.dim} "
          f"round {t}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"(= {ROUNDING_BAND} x the CPU's distance from fp64; the card's "
          f"{card64:.3e}) max|craft|={float(want.abs().max()):.3e} "
          f"clip_share={share:.4f} early_out={card.early_outs} ok={ok}",
          flush=True)
    if not ok:
        failures.append(f"backdoor craft card vs CPU: err {err}")

    eps = float(np.finfo(np.float32).eps)
    mm = [MinMaxAttack(1.5), MinMaxAttack(1.5)]
    got = mm[0].craft(rows, ctx).cpu()
    want = mm[1].craft(rows.cpu(), cpu_ctx)
    g_card, g_cpu = float(mm[0].last_gamma), float(mm[1].last_gamma)
    # The last bisection step: hi after the doublings (the first of 10,
    # 20, ... above gamma) over 2**25; plus the f32 spacing of gamma, to
    # which the grid rounds.
    hi = 10.0
    while hi <= max(g_card, g_cpu):
        hi *= 2.0
    step = hi / 2 ** 25
    dg = abs(g_card - g_cpu)
    spacing = float(np.spacing(np.float32(max(g_card, g_cpu))))
    _, sd = cohort_stats(rows.cpu())
    band = (F_MAIN * eps * float(rows.abs().max()) + dg * sd
            + g_cpu * sd * F_MAIN * eps + eps * want.abs())
    err = float((got - want).abs().max())
    ok = (dg <= step + 2 * spacing
          and bool(((got - want).abs() <= band).all()))
    print(f"[attack] minmax craft card vs CPU, f={F_MAIN} d={exp.flat.dim}: "
          f"gamma card={g_card:.9g} cpu={g_cpu:.9g} step={step:.3e} "
          f"max_abs_err={err:.3e} ok={ok}", flush=True)
    if not ok:
        failures.append(f"minmax craft card vs CPU: gamma {g_card} vs "
                        f"{g_cpu}, err {err}")


def check_watchdog(ds, failures):
    """A short full-width NoDefense run whose finite bit-scaled corruption
    explodes the weights: the watchdog must roll back once, then raise
    FloatingPointError with the state restored and finite.  That
    exception is the expected outcome; any other outcome fails."""
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )

    fc = FaultConfig(corrupt=0.3, corrupt_mode="scale", corrupt_scale=1e30,
                     watchdog_norm=1e6, max_rollbacks=1)
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=N_MAIN,
                           mal_prop=0.1, batch_size=128, epochs=4,
                           test_step=2, defense="NoDefense",
                           synth_train=60_000, synth_test=10_000, faults=fc)
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cuda")
    w0 = exp.state.weights.clone()
    lines, raised = [], None
    try:
        exp.run(log=lines.append)
    except FloatingPointError as err:
        raised = str(err)
    rollbacks = [s for s in lines if s.startswith("!! server state")]
    ok = (raised is not None and len(rollbacks) == 2
          and exp.state.round == 0 and torch.equal(exp.state.weights, w0)
          and bool(torch.isfinite(exp.state.weights).all()))
    print(f"[main] watchdog    scale-corrupt NoDefense: rollbacks="
          f"{len(rollbacks)} raised={raised!r} restored_round="
          f"{exp.state.round} ok={ok}", flush=True)
    if not ok:
        failures.append(f"watchdog: raised={raised!r}, lines={rollbacks}")


# Phase 8's runs: (label, defense, mal_prop, faults?, config fields, n,
# rounds, must launch, must not launch).  The bf16 routes launch only
# where the JAX package's dispatch takes them: the fused score kernel of
# unmasked Krum on a bf16 wire or with distance_dtype='bfloat16', the
# distance kernel where distance_dtype='bfloat16' asks for the matrix.
_F32_GRAM = ("pairwise_distances", "krum_scores")
_BF16_GRAM = ("pairwise_distances[bf16]", "krum_scores[bf16]")
P8 = dict(participation=0.6)
BF = dict(grad_dtype="bfloat16")
DD = dict(distance_dtype="bfloat16")
KNOB_RUNS = (
    [("a participation", d, 0.24, False, P8, N_MAIN, ROUNDS, k,
      _BF16_GRAM) for d, (k, _) in CLEAN_KERNELS.items()]
    + [("a participation", "TrimmedMean", 0.1, True, P8, N_MAIN, ROUNDS,
        ("masked_trimmed_mean",), _BF16_GRAM)]
    + [("b local_steps 3", "Krum", 0.24, False, dict(local_steps=3),
        N_MAIN, ROUNDS, ("krum_scores",), _BF16_GRAM),
       ("b local_steps 3", "TrimmedMean", 0.24, False,
        dict(local_steps=3), N_MAIN, ROUNDS, ("trimmed_mean",), _BF16_GRAM),
       ("b local_steps 3 faded", "Krum", 0.24, False,
        dict(local_steps=3, server_uses_faded_lr=True), N_MAIN, ROUNDS,
        ("krum_scores",), _BF16_GRAM)]
    + [("c bf16 wire", "NoDefense", 0.24, False, BF, N_MAIN, ROUNDS, (),
        _F32_GRAM + _BF16_GRAM),
       ("c bf16 wire", "Krum", 0.24, False, BF, N_MAIN, ROUNDS,
        ("krum_scores[bf16]",), ("krum_scores",)),
       ("c bf16 wire", "TrimmedMean", 0.24, False, BF, N_MAIN, ROUNDS,
        ("trimmed_mean",), _BF16_GRAM),
       ("c bf16 wire", "Bulyan", 0.24, False, BF, N_MAIN, ROUNDS,
        ("pairwise_distances", "trimmed_mean"), _BF16_GRAM),
       ("c bf16 wire", "Median", 0.24, False, BF, N_MAIN, ROUNDS,
        ("median",), _BF16_GRAM),
       ("c bf16 wire", "TrimmedMean", 0.1, True, BF, N_MAIN, ROUNDS,
        ("masked_trimmed_mean",), _BF16_GRAM),
       ("c bf16 wire", "Median", 0.1, True, BF, N_MAIN, ROUNDS,
        ("masked_median",), _BF16_GRAM)]
    + [("d bf16 distances", "Krum", 0.24, False, DD, N_MAIN, ROUNDS,
        ("krum_scores[bf16]",), _F32_GRAM),
       ("d bf16 distances", "Bulyan", 0.24, False, DD, N_MAIN, ROUNDS,
        ("pairwise_distances[bf16]", "trimmed_mean"), _F32_GRAM),
       ("d bf16 distances", "Krum", 0.1, True, DD, N_MAIN, ROUNDS,
        ("pairwise_distances[bf16]",), _F32_GRAM + ("krum_scores[bf16]",))]
    + [("e bulyan_batch_select 4", "Bulyan", 0.24, False,
        dict(bulyan_batch_select=4), N_MAIN, ROUNDS,
        ("pairwise_distances", "trimmed_mean"), _BF16_GRAM),
       ("f femnist_style", "Krum", 0.24, False,
        dict(partition="femnist_style"), N_MAIN, ROUNDS, ("krum_scores",),
        _BF16_GRAM)]
    + [("g n=1000 bf16", d, 0.24, False, dict(BF, **DD), 1000, 6, k, b)
       for d, k, b in (("Krum", ("krum_scores[bf16]",), ("krum_scores",)),
                       ("TrimmedMean", ("trimmed_mean",), _BF16_GRAM))])


def checked_defense(exp, rounds, excluded, errs, dist_errs,
                    attr="defense_fn", defense=None, diag_errs=None):
    """Wraps ``exp.defense_fn`` (or the engine's attribute ``attr``, the
    defense named ``defense``: phase 12's traffic fallback) so that for
    the first ``rounds`` calls the
    aggregate on the card is held against the plain versions on the CPU
    on the same wire and mask (phase 4's tolerances: Krum's and the
    median's pick exact; a mean within n rounding steps of the largest
    |g|, plus one bf16 ulp (at most 2^-7 of it) of the aggregate for
    NoDefense's mean of a bf16 wire, whose f32 sum is rounded once).
    The check's seconds, from the card's last kernel on, go to
    ``excluded``.

    Bulyan's and Krum's distance matrix on the card (the distance kernel
    at the cohort's shape, f32 or bf16, where the defense calls it: always
    for Bulyan and masked Krum, on the guard's fallback for fused Krum) is
    held against the plain version on the CPU on the same operand, in
    phase 3's d^2 band, with a zero diagonal and symmetric; (largest |D -
    plain|, ok) goes to ``dist_errs``.  The CPU twin then selects from the
    card's matrix: the card puts identical rows exactly 0 apart and the
    plain Gram does not, so the CPU may pick tied rows in another order;
    a Bulyan tail that keeps 3 of 52 bf16 values breaks exact +-dev ties
    by that order, and a weighted Krum winner (scaled by its own staleness
    weight) must be the same one of the identical crafted rows.

    A weighted median (phase 10) is a pick decided by sums of the
    weights: where the card and the CPU pick different values, each pick
    must be a lower weighted median of the column in fp64 within the
    weight sums' rounding (:func:`weighted_median_adjudicated`); the
    count of such columns goes to the error's place in ``errs``.

    A defense called with ``telemetry=True`` (phase 15) returns its
    diagnostics too: the CPU twin's, from the same call, are held against
    the card's (:func:`diagnostics_vs_cpu`), (worst banded error, ok) to
    ``diag_errs``."""
    import torch

    from attacking_federate_learning_tpu_torch.defenses import kernels as K
    from attacking_federate_learning_tpu_torch.ops.distances import (
        pairwise_distances_plain
    )

    eps = float(np.finfo(np.float32).eps)
    inner, defense = getattr(exp, attr), defense or exp.cfg.defense
    distances = K.pairwise_distances

    def check_distances(G, D):
        G64 = G.double().cpu()
        sq64 = (G64 * G64).sum(1)
        d = G.shape[1]
        band = d2_band(sq64, kernel_chain(d)) + d2_band(sq64, d)
        got, want = D.cpu(), pairwise_distances_plain(G.cpu())
        ok = (bool(((got.double() ** 2 - want.double() ** 2).abs()
                    <= band).all())
              and bool((got == got.T).all())
              and bool((got.diagonal() == 0).all()))
        dist_errs.append((float((got - want).abs().max()), ok))

    def checked(grads, n, f, **kw):
        if len(errs) >= rounds:
            return inner(grads, n, f, **kw)
        seen = []
        if defense in ("Bulyan", "Krum"):
            K.pairwise_distances = lambda G: seen.append(
                (G, distances(G))) or seen[-1][1]
        try:
            out = got = inner(grads, n, f, **kw)
        finally:
            K.pairwise_distances = distances
        torch.cuda.synchronize()
        a = time.perf_counter()
        if seen:
            check_distances(*seen[0])
            K.pairwise_distances = lambda G: seen[0][1].cpu()
        try:
            want = inner(grads.cpu(), n, f,
                         **{k: v.cpu() if isinstance(v, torch.Tensor)
                            else v for k, v in kw.items()})
        finally:
            K.pairwise_distances = distances
        if isinstance(got, tuple):
            (got, gdiag), (want, wdiag) = got, want
            if diag_errs is not None:
                diag_errs.append(diagnostics_vs_cpu(gdiag, wdiag, grads))
        want = want.float()
        g = got.float().cpu()
        if defense == "Median" and kw.get("weights") is not None:
            errs.append(weighted_median_adjudicated(
                grads.cpu(), kw["mask"].cpu(), kw["weights"].cpu(), g, want))
            excluded.append(time.perf_counter() - a)
            return out
        atol = 0.0 if defense in ("Krum", "Median") else (
            2.0 * n * eps * float(grads.float().abs().max()))
        if defense == "NoDefense" and grads.dtype == torch.bfloat16:
            atol = atol + 2.0 ** -7 * want.abs()
        if kw.get("mask") is not None and not bool(kw["mask"].any()):
            # A round that delivers nothing (phase 10) aggregates an empty
            # mask: NaN or +inf on both devices, equal.
            same = (g == want) | (torch.isnan(g) & torch.isnan(want))
            err = torch.nan_to_num(torch.where(same, 0.0, (g - want).abs()),
                                   nan=math.inf)
        else:
            err = (g - want).abs()
        errs.append((float(err.max()), bool((err <= atol).all())))
        excluded.append(time.perf_counter() - a)
        return out

    setattr(exp, attr, checked)


def weighted_median_adjudicated(G, mask, w, got, want):
    """(columns where ``got`` and ``want`` differ, ok) for two lower
    weighted medians of the alive rows of the (n, d) CPU matrix ``G``.
    The pick is the smallest alive value whose alive weight at or below
    it reaches half the alive weight, a decision made on f32 sums whose
    order differs between the kernel (row order) and the plain version
    (sorted order); on non-dyadic weights (poly: 1, 1/sqrt 2, 1/sqrt 3)
    a column whose weight below a value is exactly half in exact
    arithmetic may go either way.  Equal columns pass; a differing
    column passes when each pick is an alive value v with W(< v) < W/2 +
    tol and W(<= v) >= W/2 - tol in fp64, tol = 2 n eps32 W (the f32
    sums' rounding, twice)."""
    import torch

    differ = torch.nonzero(got != want).flatten()
    if differ.numel() == 0:
        return 0, True
    Gc = G[:, differ].double()
    wm = torch.where(mask, w, 0.0).double()[:, None]
    total = float(wm.sum())
    half = total / 2.0
    tol = 2.0 * G.shape[0] * float(np.finfo(np.float32).eps) * total

    def valid(v):
        v = v.double()[None, :]
        below = (wm * (Gc < v)).sum(0)
        upto = (wm * (Gc <= v)).sum(0)
        present = ((Gc == v) & mask[:, None]).any(0)
        return present & (below < half + tol) & (upto >= half - tol)

    ok = bool((valid(got[differ]) & valid(want[differ])).all())
    return int(differ.numel()), ok


def run_knobs_path(ds, failures):
    """Phase 8: the round's knobs through run() at full width (mnist_mlp,
    SYNTH_MNIST 60,000 / 10,000, n = 100, B = 128, z = 1.5): partial
    participation, local steps, the bf16 wire, bf16 distances, batched
    Bulyan selection, femnist_style, and n = 1,000 on a bf16 wire.  Each
    run must launch the routes it must and none it must not, its cohorts
    must equal a host replay, and three rounds' aggregates must hold
    against the CPU.  Returns launches per kernel summed over the runs."""
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import FaultConfig
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.core.population import (
        legacy_cohort
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils import threefry

    totals = {name: 0 for name in _build.LAUNCHES}
    faults = FaultConfig(dropout=0.1, corrupt=0.05, corrupt_mode="nan")
    for (label, defense, mal_prop, faulted, knobs, n, rounds, kernels,
         banned) in KNOB_RUNS:
        fc = None
        if faulted:
            fc = faults if "participation" in knobs else FaultConfig(
                **FAULTS_MAIN)
        cfg = main_config(defense, mal_prop, fc, **knobs)
        cfg.users_count, cfg.epochs = n, rounds
        cfg.test_step = TEST_STEP if rounds == ROUNDS else rounds - 1
        exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                  device="cuda")
        assert exp.flat.dim == D_MLP
        cohorts, draw_s = [], []
        draw = exp.participants

        def recorded(t, draw=draw, cohorts=cohorts, draw_s=draw_s):
            # The cohort draw's host time: run_round draws before the
            # deliver window that drive() times.
            a = time.perf_counter()
            part = draw(t)
            draw_s.append(time.perf_counter() - a)
            cohorts.append((t, part))
            return part

        exp.participants = recorded
        excluded, errs, dist_errs = [], [], []
        checked_defense(exp, 3, excluded, errs, dist_errs)
        run = drive(exp, kernels, banned, failures,
                    f"knobs {label} {defense}", excluded)
        for name, count in run["launches"].items():
            totals[name] += count
        # The cohort each round used, against a replay from the seed.
        key = threefry.key(cfg.seed ^ 0x9A47)
        cohorts_ok = all(
            (part is None) == (cfg.participation >= 1.0)
            and (part is None or (
                np.array_equal(part, legacy_cohort(key, t, exp.n, exp.f,
                                                   exp.m, exp.m_mal))
                and (part[:exp.m_mal] < exp.f).all()
                and (part[exp.m_mal:] >= exp.f).all()
                and len(set(part.tolist())) == exp.m))
            for t, part in cohorts)
        # Fused Krum reaches the distance kernel only on its guard's
        # fallback, masked Krum every round.
        dist_counts = {"Bulyan": (3,), "Krum": (0, 1, 2, 3)}.get(defense,
                                                                 (0,))
        agg_ok = (len(errs) == 3 and all(ok for _, ok in errs)
                  and len(dist_errs) in dist_counts
                  and all(ok for _, ok in dist_errs))
        if not cohorts_ok or not agg_ok:
            failures.append(f"knobs {label} {defense}: cohorts_ok="
                            f"{cohorts_ok} aggregates vs CPU {errs} "
                            f"distances vs CPU {dist_errs}")
        beside = ""
        if dist_errs:
            beside = (f"D_vs_cpu_max_abs_err="
                      f"{max(e for e, _ in dist_errs):.3e} ")
        if cfg.participation < 1.0:
            beside += f"cohort_draw_ms={1e3 * statistics.median(draw_s):.3f} "
        if fc is not None:
            beside += (f"fault_counts_match_replay={run['counts_ok']} "
                      f"alive_min/max={min(run['alive'])}/"
                      f"{max(run['alive'])} ")
        print(f"[knobs] {label:24s} {defense:11s} n={exp.n} m={exp.m} "
              f"f={exp.f} m_mal={exp.m_mal} acc = {run['acc_txt']} % "
              f"median_round_ms={run['median_ms']:.3f} "
              f"deliver_ms={run['deliver_ms']:.3f} "
              f"peak_gib={run['peak_gib']:.2f} {beside}"
              f"cohorts_match_replay={cohorts_ok} "
              f"agg_vs_cpu_max_abs_err="
              f"{max(e for e, _ in errs) if errs else float('nan'):.3e} "
              f"ok={agg_ok} launches={run['launches']} "
              f"per_round={run['per_round']} finite={run['finite']}",
              flush=True)
        del exp
        gc.collect()
    return totals



# Phase 9's runs: (label, defense, mal_prop, faulted, must launch, must not
# launch), mnist_mlp at phase 5's width, rounds 0..20, test_step 5,
# checkpoint_every 5, preempted at the first boundary at or past round 8.
P9_TEST_STEP = 5
P9_EVERY = 5
P9_PREEMPT_AT = 8
P9_RUNS = (("(a) ALIE Krum", "Krum", 0.24, False, ("krum_scores",), ()),
           ("(b) ALIE TrimmedMean faulted", "TrimmedMean", 0.1, True,
            ("masked_trimmed_mean",), ("krum_scores",)))


def p9_config(defense, mal_prop, faulted, root, **kw):
    """Phase 5's configuration with the lifecycle's cadence, its run_dir
    and log_dir under ``root``."""
    import dataclasses

    from attacking_federate_learning_tpu_torch.config import FaultConfig

    cfg = main_config(defense, mal_prop,
                      FaultConfig(**FAULTS_MAIN) if faulted else None)
    return dataclasses.replace(
        cfg, test_step=P9_TEST_STEP, checkpoint_every=P9_EVERY,
        run_dir=os.path.join(root, "runs"),
        log_dir=os.path.join(root, "logs"), **kw)


def p9_attempt(cfg, ds, run_id, failures, label, kernels, banned,
               shutdown=None, resume=False):
    """One attempt of a journaled run on the card: a fresh engine, its
    own RunLogger (lines teed to ``<log_dir>/<run_id>.txt``), journal and
    Checkpointer; resumed from ``Checkpointer.latest()`` with ``resume``.
    Launch counters are zeroed just before run() and read just after.
    Returns (engine, launches, per-round weight sums, round seconds,
    the Preempted raised or None, the checkpointer)."""
    import torch

    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.checkpoint import (
        Checkpointer
    )
    from attacking_federate_learning_tpu_torch.utils.lifecycle import (
        Preempted, RunJournal
    )
    from attacking_federate_learning_tpu_torch.utils.metrics import (
        RunLogger
    )

    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cuda")
    journal = RunJournal(cfg.run_dir, run_id)
    ck = Checkpointer(cfg, auto_dir=journal.dir)
    if resume:
        state, extra = ck.resume(ck.latest(), with_extra=True,
                                 device="cuda")
        exp.state = state
        exp.restore_carry_state(extra)
        on_card = [t.device.type == "cuda" for t in
                   (exp.state.weights, exp.state.velocity,
                    *(exp.fault_state or {}).values(),
                    *(exp.async_state or {}).values())]
        if not all(on_card):
            failures.append(f"{label}: resumed state not on the card "
                            f"{on_card}")
    sums, round_s = [], []
    inner = exp.run_round

    def traced_round(t, inner=inner):
        torch.cuda.synchronize()
        a = time.perf_counter()
        state = inner(t)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - a)
        sums.append((t, state.weights.double().sum()))
        return state

    exp.run_round = traced_round
    stopped = None
    with RunLogger(cfg, os.path.join(cfg.log_dir, run_id + ".txt"),
                   cfg.log_dir, jsonl_name=run_id) as logger:
        torch.cuda.synchronize()
        _build.reset_launches()
        try:
            exp.run(logger, checkpointer=ck, journal=journal,
                    shutdown=shutdown)
        except Preempted as e:
            stopped = e
        launches = dict(_build.LAUNCHES)
    missing = [k for k in kernels if launches[k] == 0]
    extra_k = [k for k in banned if launches[k] != 0]
    if missing or extra_k:
        failures.append(f"{label}: missing launches {missing}, unexpected "
                        f"launches {extra_k}")
    sums = [(t, float(s)) for t, s in sums]
    return exp, launches, sums, round_s, stopped, ck


def p9_triplet(ds, label, defense, mal_prop, faulted, kernels, banned,
               failures, root, want_extra=None, tag="lifecycle", **kw):
    """(a)/(b): an uninterrupted journaled run, then the same config
    preempted at the first boundary at or past round 8 and resumed in a
    third engine.  ``want_extra`` maps the carry arrays the checkpoint
    must hold (``extra_*``) to their shapes; ``kw`` goes to the config
    (phase 10's async knobs).  Returns launches summed over the three
    runs and what the caller prints."""
    import numpy as np
    import torch

    from attacking_federate_learning_tpu_torch.core.faults import (
        fault_masks
    )
    from attacking_federate_learning_tpu_torch.utils.lifecycle import (
        GracefulShutdown, RunJournal
    )
    from attacking_federate_learning_tpu_torch.utils.metrics import (
        iter_events
    )

    one = p9_config(defense, mal_prop, faulted, os.path.join(root, "one"),
                    **kw)
    two = p9_config(defense, mal_prop, faulted, os.path.join(root, "two"),
                    **kw)
    rid = "p9"
    totals = {}
    full, l1, sums1, round_s, _, _ = p9_attempt(
        one, ds, rid, failures, f"{label} run 1", kernels, banned)
    first, l2, sums2, _, stopped, ck = p9_attempt(
        two, ds, rid, failures, f"{label} run 2", kernels, banned,
        shutdown=GracefulShutdown(preempt_at_round=P9_PREEMPT_AT))
    latest = ck.latest()
    with np.load(latest) as z:
        saved_round = int(z["round"])
        extras = {k: z[k].shape for k in z.files if k.startswith("extra_")}
    last, l3, sums3, _, _, _ = p9_attempt(
        two, ds, rid, failures, f"{label} run 3", kernels, banned,
        resume=True)
    for launches in (l1, l2, l3):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    bit_equal = (torch.equal(last.state.weights, full.state.weights)
                 and torch.equal(last.state.velocity, full.state.velocity))
    parted = None
    if not bit_equal:
        resumed = dict(sums2 + sums3)
        parted = next((t for t, s in sums1 if resumed.get(t) != s), None)
    problems = RunJournal(two.run_dir, rid).verify(epochs=one.epochs,
                                                   test_step=P9_TEST_STEP)
    manifest = RunJournal(two.run_dir, rid).read_manifest()
    events = list(iter_events(os.path.join(two.log_dir, rid + ".jsonl")))
    evals = sorted(e["round"] for e in events if e["kind"] == "eval")
    want_evals = sorted(set(range(0, one.epochs, P9_TEST_STEP))
                        | {one.epochs - 1})
    ok = (stopped is not None and stopped.round == 10
          and saved_round == 11 and bit_equal and problems == []
          and evals == want_evals and manifest["status"] == "done"
          and extras == (want_extra or {}))
    counts_ok = True
    if faulted:
        keys = ("round", "injected_dropout", "injected_straggler",
                "injected_corrupt", "quarantined")
        got = [{k: e[k] for k in keys} for e in events
               if e["kind"] == "fault"]
        want = []
        for t in range(one.epochs):
            drop, stale, corrupt = fault_masks(full._fault_key, t, full.m,
                                               full.m_mal, full.faults)
            want.append({"round": t, "injected_dropout": int(drop.sum()),
                         "injected_straggler": int(stale.sum()),
                         "injected_corrupt": int(corrupt.sum()),
                         "quarantined": int(drop.sum() + corrupt.sum())})
        one_events = iter_events(os.path.join(one.log_dir, rid + ".jsonl"))
        run1 = [{k: e[k] for k in keys} for e in one_events
                if e["kind"] == "fault"]
        counts_ok = got == want == run1
        ok = ok and counts_ok
    if not ok:
        failures.append(
            f"{label}: preempted at {stopped and stopped.round} (want 10), "
            f"checkpoint round {saved_round} (want 11), bit_equal="
            f"{bit_equal} (first parting round {parted}), journal "
            f"{problems}, evals {evals}, status {manifest['status']}, "
            f"fault counts ok {counts_ok}, carry arrays {extras} (want "
            f"{want_extra})")
    out = {"full": full, "last": last, "ck": ck, "latest": latest,
           "round_ms": 1e3 * statistics.median(round_s),
           "rounds_per_s": RunJournal(one.run_dir, rid).read_manifest()[
               "rounds_per_s"]}
    print(f"[{tag}] {label:29s} f={full.f}: preempted at round "
          f"{stopped and stopped.round}, auto-checkpoint round "
          f"{saved_round}{''.join(f' {k} {v}' for k, v in extras.items())}, "
          f"resumed to round {last.state.round}: bit_equal={bit_equal} "
          f"first_parting_round={parted} journal_verify={problems} "
          f"evals={evals} manifest={manifest['status']} "
          f"attempts={manifest['attempt']}"
          + (f" fault_counts_match_replay_and_run1={counts_ok}"
             if faulted else "")
          + f" launches run1/2/3={[{k: v for k, v in x.items() if v} for x in (l1, l2, l3)]}"
          f" ok={ok}", flush=True)
    return totals, out


def time_save_resume(exp, ck, smi, label, reps=3, tag="lifecycle"):
    """Host ms (median of ``reps``) of one save_auto of ``exp``'s state
    with its carry state (the device-to-host copy included) and of one
    resume of that file onto the card (restore_carry_state and a
    synchronise included), with the file's bytes; printed, not gated."""
    import torch

    save_s, resume_s = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = time.perf_counter()
        path = ck.save_auto(exp.state, extra=exp.carry_state_host())
        save_s.append(time.perf_counter() - a)
        a = time.perf_counter()
        state, extra = ck.resume(path, with_extra=True, device="cuda")
        exp.state = state
        exp.restore_carry_state(extra)
        torch.cuda.synchronize()
        resume_s.append(time.perf_counter() - a)
    size = os.path.getsize(path)
    print(f"[{tag}] {label}: save_auto_ms={1e3 * statistics.median(save_s):.3f} "
          f"resume_ms={1e3 * statistics.median(resume_s):.3f} "
          f"bytes={size} (median of {reps}; host clock, fsync included) "
          f"on {smi}", flush=True)


def check_watchdog_checkpoints(ds, failures, root):
    """(c) Phase 5's bit-scaled corruption under NoDefense with
    checkpoint_every 2 and a Checkpointer.  At phase 5's rate (0.3) a
    row is corrupted in round 0, before any checkpoint; at 0.01 the
    schedule (n = 100, f = 10) first corrupts round 5, so the boundary of
    round 4 saves a good state first.  The rollback must restore that
    state (round counter 5), not round 0, write it again as an
    on-failure auto-checkpoint, and past max_rollbacks (1) raise
    FloatingPointError with that state restored and finite."""
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.core.faults import (
        fault_masks
    )
    from attacking_federate_learning_tpu_torch.utils.checkpoint import (
        Checkpointer
    )

    fc = FaultConfig(corrupt=0.01, corrupt_mode="scale", corrupt_scale=1e30,
                     watchdog_norm=1e6, max_rollbacks=1)
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=N_MAIN,
                           mal_prop=0.1, batch_size=128, epochs=8,
                           test_step=2, checkpoint_every=2,
                           defense="NoDefense", synth_train=60_000,
                           synth_test=10_000, faults=fc,
                           run_dir=os.path.join(root, "runs"),
                           log_dir=os.path.join(root, "logs"))
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cuda")
    corrupted = [t for t in range(cfg.epochs)
                 if fault_masks(exp._fault_key, t, exp.m, exp.m_mal,
                                fc)[2].any()]
    ck = Checkpointer(cfg)
    saves, inner = [], ck.save_auto

    def spy(state, extra=None, inner=inner):
        saves.append(int(state.round))
        return inner(state, extra)

    ck.save_auto = spy
    lines, raised = [], None
    try:
        exp.run(checkpointer=ck, log=lines.append)
    except FloatingPointError as err:
        raised = str(err)
    rollbacks = [s for s in lines if s.startswith("!! server state")]
    restored = ck.resume(ck.latest(), device="cuda")
    ok = (corrupted[:1] == [5] and raised is not None
          and saves == [1, 3, 5, 5, 5] and len(rollbacks) == 2
          and all("rolling back to round 5" in s for s in rollbacks)
          and exp.state.round == 5 == restored.round
          and torch.equal(exp.state.weights, restored.weights)
          and bool(torch.isfinite(exp.state.weights).all()))
    print(f"[lifecycle] (c) watchdog with checkpoints: corrupted rounds "
          f"{corrupted} auto_saves_at_rounds={saves} rollbacks="
          f"{len(rollbacks)} {rollbacks[:1]} raised={raised!r} "
          f"restored_round={exp.state.round} ok={ok}", flush=True)
    if not ok:
        failures.append(f"watchdog with checkpoints: corrupted {corrupted}, "
                        f"saves {saves}, lines {rollbacks}, raised "
                        f"{raised!r}, round {exp.state.round}")


def check_cli_lifecycle(failures, root):
    """(d) The CLI on the card as a subprocess: the injected preempt
    (FL_PREEMPT_AT_ROUND=8) exits 75 and --resume exits 0; then a real
    SIGTERM sent to a longer run once it has printed its first Test set
    line exits 75, and --resume exits 0.  Each run's events pass the
    port's validate_event and its journal verifies."""
    import signal

    from attacking_federate_learning_tpu_torch.utils.lifecycle import (
        RunJournal
    )
    from attacking_federate_learning_tpu_torch.utils.metrics import (
        iter_events
    )

    env = {**os.environ, "PYTHONPATH": ROOT}
    env.pop("FL_PREEMPT_AT_ROUND", None)

    def argv(run_id, epochs, *extra):
        return [sys.executable, "-m", f"{PKG}.cli", "-s", "SYNTH_MNIST",
                "-n", str(N_MAIN), "-e", str(epochs), "--journal",
                "--run-id", run_id, "--checkpoint-every", "5",
                "--run-dir", os.path.join(root, "runs"),
                "--log-dir", os.path.join(root, "logs"), *extra]

    def audit(run_id, epochs):
        problems = RunJournal(os.path.join(root, "runs"), run_id).verify(
            epochs=epochs, test_step=5)
        try:
            n = sum(1 for _ in iter_events(
                os.path.join(root, "logs", run_id + ".jsonl")))
        except ValueError as e:
            return problems + [str(e)], 0
        return problems, n

    t0 = time.perf_counter()
    inj = {**env, "FL_PREEMPT_AT_ROUND": str(P9_PREEMPT_AT)}
    rcs = [subprocess.run(argv("smoke", ROUNDS), env=inj, cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=600).returncode]
    rcs.append(subprocess.run(argv("smoke", ROUNDS, "--resume"), env=inj,
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=600).returncode)
    problems, n_events = audit("smoke", ROUNDS)
    ok = rcs == [75, 0] and problems == [] and n_events > 0
    print(f"[lifecycle] (d) CLI FL_PREEMPT_AT_ROUND={P9_PREEMPT_AT}: exit "
          f"codes {rcs} (want [75, 0]) events={n_events} journal_verify="
          f"{problems} ok={ok} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not ok:
        failures.append(f"CLI injected preempt: exit codes {rcs}, journal "
                        f"{problems}, events {n_events}")

    t0 = time.perf_counter()
    long_rounds = 1000
    proc = subprocess.Popen(argv("smoke_sig", long_rounds), env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        seen = False
        for line in proc.stdout:
            if line.startswith("Test set"):
                proc.send_signal(signal.SIGTERM)
                seen = True
                break
        proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rcs = [proc.returncode]
    resumed = subprocess.run(argv("smoke_sig", long_rounds, "--resume"),
                             env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=900)
    rcs.append(resumed.returncode)
    at = next((s for s in resumed.stdout.splitlines()
               if s.startswith("Resumed from round")), None)
    problems, n_events = audit("smoke_sig", long_rounds)
    ok = seen and rcs == [75, 0] and problems == [] and n_events > 0
    print(f"[lifecycle] (d) CLI real SIGTERM after the first Test set "
          f"line: exit codes {rcs} (want [75, 0]) '{at}' of {long_rounds} "
          f"events={n_events} journal_verify={problems} ok={ok} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not ok:
        failures.append(f"CLI SIGTERM: saw Test set {seen}, exit codes "
                        f"{rcs}, journal {problems}, events {n_events}")


def run_lifecycle_path(ds, failures, smi, phase5_krum_ms):
    """Phase 9.  Returns launches per kernel summed over (a) and (b)."""
    import tempfile

    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.checkpoint import (
        Checkpointer
    )

    totals = {name: 0 for name in _build.LAUNCHES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p9_") as root:
        for i, (label, defense, mal_prop, faulted, kernels,
                banned) in enumerate(P9_RUNS):
            launches, out = p9_triplet(
                ds, label, defense, mal_prop, faulted, kernels, banned,
                failures, os.path.join(root, str(i)),
                want_extra=({"extra_stale": (2, N_MAIN, D_MLP)} if faulted
                            else None))
            for k, v in launches.items():
                totals[k] += v
            if not faulted:
                print(f"[lifecycle] (a) median_round_ms={out['round_ms']:.3f}"
                      f" with checkpoint_every {P9_EVERY} (run 1; the "
                      f"boundaries' work is outside it), rounds_per_s="
                      f"{out['rounds_per_s']} (run 1's loop, boundaries "
                      f"included), beside phase 5's Krum "
                      f"median_round_ms={phase5_krum_ms:.3f} on {smi}",
                      flush=True)
            time_save_resume(out["last"], out["ck"], smi,
                             f"{label} state"
                             + (" + straggler ring" if faulted else ""))
            del out
            gc.collect()
            torch.cuda.empty_cache()
        check_watchdog_checkpoints(ds, failures, os.path.join(root, "c"))
        # One save and resume of phase 7's WRN-40-4 engine (its state:
        # the dataset is cut to 1,000 / 100 images, which leaves it as
        # it is).
        wrn = ExperimentConfig(dataset=C.CIFAR100, model="wideresnet40_4",
                               users_count=10, mal_prop=0.2,
                               defense="TrimmedMean", synth_train=1_000,
                               synth_test=100,
                               run_dir=os.path.join(root, "wrn"))
        exp = FederatedExperiment(
            wrn, DriftAttack(1.5), load_dataset(
                wrn.dataset, seed=0, synth_train=1_000, synth_test=100),
            device="cuda")
        if exp.flat.dim != D_WRN:
            failures.append(f"WRN-40-4 d={exp.flat.dim}")
        time_save_resume(exp, Checkpointer(wrn), smi,
                         f"WRN-40-4 state (d={exp.flat.dim})")
        del exp
        gc.collect()
        torch.cuda.empty_cache()
        check_cli_lifecycle(failures, os.path.join(root, "d"))
    return totals


# Phase 10's runs: (label, defense, mal_prop, async_buffer k, staleness
# weighting, faulted, attack, must launch), mnist_mlp at phase 5's width,
# rounds 0..20, async_max_staleness 2 (a ring of depth 3).  Every other
# kernel must not launch: a delivered round always passes a mask, so the
# unmasked kernels 3 and 4 never run, and masked Krum scores by sort over
# the distance kernel (never the fused score kernel), as in the JAX
# package's Pallas suite.
P10_STALENESS = 2
P10_CHECKED = 5                  # rounds 0..4 held against the CPU
P10_RUNS = (
    ("(a)", "NoDefense", 0.24, 64, "none", False, "alie", ()),
    ("(a)", "Krum", 0.24, 64, "poly", False, "alie",
     ("pairwise_distances",)),
    ("(a)", "TrimmedMean", 0.24, 64, "poly", False, "alie",
     ("masked_trimmed_mean",)),
    ("(a)", "Median", 0.24, 64, "const", False, "alie", ("masked_median",)),
    # Bulyan's bound at n = k: k >= 4f + 3 = 43.
    ("(b)", "Bulyan", 0.1, 50, "none", False, "alie",
     ("pairwise_distances", "masked_trimmed_mean")),
    ("(b)", "Bulyan", 0.1, 50, "poly", False, "alie",
     ("pairwise_distances", "masked_trimmed_mean")),
    ("(c)", "TrimmedMean", 0.1, 50, "poly", True, "alie",
     ("masked_trimmed_mean",)),
    ("(c)", "Median", 0.1, 50, "poly", True, "alie", ("masked_median",)),
    ("(c)", "Krum", 0.1, 50, "const", True, "alie", ("pairwise_distances",)),
    ("(d)", "TrimmedMean", 0.24, 64, "poly", False, "backdoor_timed",
     ("masked_trimmed_mean",)),
)
# The sort kernels that take the staleness weights, and the defense module
# whose name binds each wrapper.
WEIGHTED_KERNELS = (("masked_trimmed_mean", "kernels"),
                    ("masked_median", "median"))


def async_config(defense, mal_prop, k, weighting, faulted, **kw):
    """Phase 5's configuration as an async round."""
    from attacking_federate_learning_tpu_torch.config import FaultConfig

    return main_config(defense, mal_prop,
                       FaultConfig(**FAULTS_MAIN) if faulted else None,
                       aggregation="async", async_buffer=k,
                       async_max_staleness=P10_STALENESS,
                       staleness_weight=weighting, **kw)


def spy_weighted_calls(calls):
    """Wraps the masked sort kernels' wrappers where the defenses bind
    them, counting their calls on the card in ``calls[(name,
    weighted)]``; returns the undo."""
    from attacking_federate_learning_tpu_torch.defenses import (
        kernels as K, median as M
    )

    modules = {"kernels": K, "median": M}
    saved = []
    for name, where in WEIGHTED_KERNELS:
        mod = modules[where]
        inner = getattr(mod, name)

        # The weights' place after (G, mask): masked_trimmed_mean(G,
        # mask, k_delta, weights), masked_median(G, mask, weights).
        at = 1 if name == "masked_trimmed_mean" else 0

        def spy(G, mask, *args, inner=inner, name=name, at=at, **kw):
            weights = args[at] if len(args) > at else kw.get("weights")
            if G.is_cuda:
                key = (name, weights is not None)
                calls[key] = calls.get(key, 0) + 1
            return inner(G, mask, *args, **kw)

        saved.append((mod, name, inner))
        setattr(mod, name, spy)

    def undo():
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return undo


def async_twin(exp, excluded, results, host_s):
    """Wraps core/async_rounds.py:async_step so that for rounds 0..4 the
    card's step is held against the same step on the CPU, from a CPU
    state of its own and on the card's gradients copied over: delivered
    masks, staleness, counts, histograms and the delivered matrix must be
    equal bit for bit (the step moves data and counts; it computes
    nothing).  (round, ok) goes to ``results``, the check's seconds to
    ``excluded``, and the card's step's host seconds (its schedule draw
    and launches, no synchronisation) to ``host_s``.  Returns the
    undo."""
    import torch

    from attacking_federate_learning_tpu_torch.core import async_rounds as A

    real = A.async_step
    cpu_state = A.init_async_state(exp.async_spec, exp.m, exp.flat.dim,
                                   "cpu")

    def twin(grads, t, key, spec, state, m_mal, faults=None, fkey=None,
             latency=None):
        a = time.perf_counter()
        out = real(grads, t, key, spec, state, m_mal, faults, fkey, latency)
        host_s.append(time.perf_counter() - a)
        if t >= P10_CHECKED:
            return out
        torch.cuda.synchronize()
        a = time.perf_counter()
        ref = real(grads.cpu(), t, key, spec, cpu_state, m_mal, faults,
                   fkey, latency)
        ok = (all(torch.equal(x.cpu(), y) for x, y in zip(out[:3], ref[:3]))
              and all(torch.equal(out[3][k].cpu(), ref[3][k])
                      for k in ("counts", "staleness_hist")))
        results.append((t, ok))
        excluded.append(time.perf_counter() - a)
        return out

    A.async_step = twin

    def undo():
        A.async_step = real
    return undo


def replay_matches(rows, cfg, exp):
    """The engine's per-round 'async' records against the port's host
    replay of the schedule (counts and histograms; nothing quarantined
    in a run without faults)."""
    from attacking_federate_learning_tpu_torch.core.async_rounds import (
        replay_schedule
    )

    want = replay_schedule(cfg, exp.m, exp.m_mal, cfg.epochs,
                           timed=exp.async_spec.timed)
    keys = ("delivered", "pending", "in_flight", "evicted", "superseded")
    return len(rows) == len(want) and all(
        all(r[k] == w[k] for k in keys) and r["quarantined"] == 0
        and [int(x) for x in r["staleness_hist"]] == w["staleness_hist"]
        for r, w in zip(rows, want))


def time_weighted_kernels(failures, smi):
    """Kernels 5 and 6 with staleness weights at the async path's shape:
    (100, 79,510), the 64 rows delivered in round 1 of (a)'s schedule with
    their poly weights, against the plain versions; the median's picks
    adjudicated as in checked_defense, the trimmed mean within
    check_mtrim's weighted band.  Prints each with its ms, plain ms and
    bound by bytes; returns nothing."""
    import torch

    from attacking_federate_learning_tpu_torch.core.async_rounds import (
        replay_schedule, staleness_weights
    )
    from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
        masked_cost, masked_median, masked_median_plain, masked_trimmed_mean,
        masked_trimmed_mean_plain
    )

    _, bytes_peak, _ = peaks_for(torch.cuda.get_device_name(0))[1]
    cfg = async_config("TrimmedMean", 0.24, 64, "poly", False)
    row = next(r for r in replay_schedule(cfg, N_MAIN, F_MAIN, 4)
               if r["delivered"])
    mask = torch.from_numpy(row["delivered_mask"]).cuda()
    stal = torch.from_numpy(row["staleness"].astype(np.int32)).cuda()
    w = staleness_weights(stal, mask, "poly")
    G = torch.from_numpy(cohort(N_MAIN, D_MLP, F_MAIN, "alie", 71)).cuda()
    n, d = G.shape
    e = int(mask.sum())
    eps = float(np.finfo(np.float32).eps)
    # The answer reads only the delivered rows and their weights.
    bound = masked_cost(n, d, e, True, 3).bytes / bytes_peak * 1e3
    k_delta = F_MAIN + 1
    got = masked_trimmed_mean(G, mask, k_delta, w)
    want = masked_trimmed_mean_plain(G, mask, k_delta, w)
    k = max(e - k_delta, 1)
    atol = 2.0 * k * eps * 2.0 * float(G[mask].abs().max())
    err, ok = close(got, want, atol, 1e-6)
    ms = time_ms(lambda: masked_trimmed_mean(G, mask, k_delta, w), 20)
    pms = time_ms(lambda: masked_trimmed_mean_plain(G, mask, k_delta, w), 5)
    print(f"[async kernel] masked_trimmed_mean weighted (poly) n={n} d={d} "
          f"e={e} k={k} max_abs_err={err:.3e} tol atol {atol:.2e} + rtol "
          f"1e-6 ok={ok} ms={ms:.4f} plain_ms={pms:.4f} bound_ms="
          f"{bound:.4f} (bytes) on {smi}", flush=True)
    if not ok:
        failures.append(f"weighted masked_trimmed_mean at e={e}: {err:.3e}")
    got = masked_median(G, mask, w)
    want = masked_median_plain(G, mask, w)
    cols, ok = weighted_median_adjudicated(G.cpu(), mask.cpu(), w.cpu(),
                                           got.cpu(), want.cpu())
    ms = time_ms(lambda: masked_median(G, mask, w), 20)
    pms = time_ms(lambda: masked_median_plain(G, mask, w), 5)
    print(f"[async kernel] masked_median weighted (poly) n={n} d={d} e={e} "
          f"columns_differing={cols} (each pick a lower weighted median "
          f"within the sums' rounding) ok={ok} ms={ms:.4f} plain_ms="
          f"{pms:.4f} bound_ms={bound:.4f} (bytes) on {smi}", flush=True)
    if not ok:
        failures.append(f"weighted masked_median at e={e}: {cols} columns")
    del G
    torch.cuda.empty_cache()


def run_async_path(ds, failures, smi):
    """Phase 10: asynchronous buffered rounds through run() at full width
    (mnist_mlp, SYNTH_MNIST 60,000 / 10,000, n = 100, B = 128, z = 1.5,
    async_max_staleness 2): (a) ALIE at f = 24, k = 64 under NoDefense
    'none', Krum 'poly', TrimmedMean 'poly' and Median 'const'; (b) ALIE
    at f = 10, k = 50 under Bulyan 'none' and 'poly'; (c) phase 5's faults
    at f = 10, k = 50 under TrimmedMean 'poly', Median 'poly' and Krum
    'const'; (d) backdoor_timed under TrimmedMean 'poly' at f = 24, k =
    64; (e) (a)'s Krum preempted at round 10 and resumed bit for bit,
    the ring and the pool in the checkpoint.  Returns launches per kernel
    summed over the runs."""
    import torch

    from attacking_federate_learning_tpu_torch.attacks import (
        DriftAttack, make_attacker
    )
    from attacking_federate_learning_tpu_torch.core import async_rounds as A
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    totals = {name: 0 for name in _build.LAUNCHES}
    time_weighted_kernels(failures, smi)
    weighted_total = {}
    for (label, defense, mal_prop, k, weighting, faulted, attack,
         kernels) in P10_RUNS:
        timed = attack == "backdoor_timed"
        cfg = async_config(defense, mal_prop, k, weighting, faulted,
                           **({"backdoor": "pattern"} if timed else {}))
        att = (make_attacker(cfg, dataset=ds, name=attack, device="cuda")
               if timed else DriftAttack(cfg.num_std))
        exp = FederatedExperiment(cfg, att, ds, device="cuda")
        assert exp.flat.dim == D_MLP and exp.async_spec.timed == timed
        banned = tuple(name for name in _build.LAUNCHES
                       if name not in kernels)
        excluded, errs, dist_errs, twin_ok, stats = [], [], [], [], []
        step_s = []
        checked_defense(exp, P10_CHECKED, excluded, errs, dist_errs)
        inner = exp.run_round
        noop = []

        def observed(t, inner=inner, stats=stats, noop=noop):
            if t == 0:
                a = time.perf_counter()
                w0 = exp.state.weights.clone()
                v0 = exp.state.velocity.clone()
                excluded.append(time.perf_counter() - a)
            out = inner(t)
            stats.append(exp.last_round_async)
            if t == 0:
                a = time.perf_counter()
                noop.append(torch.equal(out.weights, w0)
                            and torch.equal(out.velocity, v0)
                            and out.round == 1)
                excluded.append(time.perf_counter() - a)
            return out

        exp.run_round = observed
        craft_ev = time_crafts(att) if timed else []
        calls = {}
        undo_spy = spy_weighted_calls(calls)
        undo_twin = async_twin(exp, excluded, twin_ok, step_s)
        try:
            run = drive(exp, kernels, banned, failures,
                        f"async {label} {defense} {weighting}", excluded)
        finally:
            undo_twin()
            undo_spy()
        for name, count in run["launches"].items():
            totals[name] += count
        for key, count in calls.items():
            weighted_total[key] = weighted_total.get(key, 0) + count
        rows = run["result"]["async"]
        delivered = [r["delivered"] for r in rows]
        triggered = all(x in (0, k) for x in delivered)
        noop_ok = (rows[0]["delivered"] != 0 or noop == [True]) and (
            label != "(a)" or (rows[0]["delivered"] == 0 and noop == [True]))
        replay_ok = faulted or replay_matches(rows, cfg, exp)
        fresh_ok = True
        if timed:
            f = exp.m_mal
            fresh_ok = all(
                bool((s["staleness"][:f][s["delivered_mask"][:f]] == 0).all())
                for s in stats)
        wanted = {name: (weighting != "none" and name in kernels)
                  for name, _ in WEIGHTED_KERNELS}
        weighted_ok = all(
            (calls.get((name, True), 0) > 0) == want
            and (calls.get((name, False), 0) == 0 or not want)
            for name, want in wanted.items())
        agg_ok = (len(errs) == P10_CHECKED and all(ok for _, ok in errs)
                  and all(ok for _, ok in dist_errs)
                  and len(dist_errs) == (P10_CHECKED if defense in (
                      "Bulyan", "Krum") else 0))
        twins_ok = (len(twin_ok) == P10_CHECKED
                    and all(ok for _, ok in twin_ok))
        ok = (triggered and noop_ok and replay_ok and fresh_ok
              and weighted_ok and agg_ok and twins_ok)
        if not ok:
            failures.append(
                f"async {label} {defense} {weighting}: delivered {delivered}"
                f" (k={k}), round-0 no-op {noop}, replay_ok={replay_ok}, "
                f"timed rows fresh {fresh_ok}, weighted calls {calls}, "
                f"aggregates vs CPU {errs} distances {dist_errs}, step vs "
                f"CPU {twin_ok}")
        hist = np.sum([r["staleness_hist"] for r in rows], axis=0)
        # The schedule's host draw alone (inside the step's host time).
        draw_s = []
        for t in range(cfg.epochs):
            a = time.perf_counter()
            A.draw_delays(exp._async_key, t, exp.m, exp.m_mal,
                          exp.async_spec, exp.faults,
                          getattr(exp, "_fault_key", None))
            draw_s.append(time.perf_counter() - a)
        beside = (f"step_host_ms={1e3 * statistics.median(step_s):.3f} "
                  f"draw_host_ms={1e3 * statistics.median(draw_s):.3f} ")
        if faulted:
            beside += (f"fault_counts_match_replay={run['counts_ok']} "
                      f"quarantined={sum(r['quarantined'] for r in rows)} "
                      f"evicted={sum(r['evicted'] for r in rows)} ")
        if timed:
            torch.cuda.synchronize()
            asr = run["result"]["asr"]
            craft_ms = statistics.median(a.elapsed_time(b)
                                         for a, b in craft_ev)
            lines_ok = backdoor_lines_ok(run["lines"], asr)
            beside += (f"asr r0/r10/r20 = "
                       f"{'/'.join(f'{a:.2f}' for a in asr)} % "
                       f"craft_ms={craft_ms:.3f} early_out_rounds="
                       f"{att.early_outs} lines_ok={lines_ok} "
                       f"timed_rows_fresh={fresh_ok} ")
            if not lines_ok:
                failures.append(f"async {label}: BEFORE/Test set/POST "
                                f"lines {run['lines']}")
        named = {f"{n}[w]" if wt else n: c for (n, wt), c in calls.items()}
        print(f"[async] {label} {defense:11s} {weighting:5s} f={exp.f} "
              f"k={k} acc r0/r10/r20 = {run['acc_txt']} % "
              f"median_round_ms={run['median_ms']:.3f} "
              f"deliver_ms={run['deliver_ms']:.3f} "
              f"peak_gib={run['peak_gib']:.2f} delivered_rounds="
              f"{sum(x > 0 for x in delivered)}/{len(delivered)} "
              f"fifo_trigger_ok={triggered} round0_noop={noop} "
              f"replay_ok={replay_ok} staleness_hist={hist.tolist()} "
              f"{beside}step_vs_cpu_ok={twins_ok} agg_vs_cpu="
              f"{[(float(f'{e:.3e}'), o) for e, o in errs]} ok={agg_ok} "
              f"sort_kernel_calls={named} "
              f"launches={ {k2: v for k2, v in run['launches'].items() if v} } "
              f"per_round={run['per_round']} finite={run['finite']} "
              f"on {smi}", flush=True)
        for line in run["lines"]:
            if line.startswith(("Test set", "##Test")):
                print(f"[async]   {line.strip()}", flush=True)
        # One more round under torch.profiler: the device's busy share.
        profile_round(exp, f"{label} {defense}", top=4, tag="async")
        del exp, att
        gc.collect()
        torch.cuda.empty_cache()
    named = {f"{n}[w]" if wt else n: c
             for (n, wt), c in weighted_total.items()}
    print(f"[async] sort-kernel calls on the card over (a)-(d), [w] with "
          f"staleness weights: {named}", flush=True)
    # -- (e) preempt and resume of (a)'s Krum 'poly' ------------------------
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_p10_") as root:
        launches, out = p9_triplet(
            ds, "(e) async Krum poly", "Krum", 0.24, False,
            ("pairwise_distances",),
            tuple(n for n in _build.LAUNCHES if n != "pairwise_distances"),
            failures, root, tag="async",
            want_extra={"extra_async_buf": (P10_STALENESS + 1, N_MAIN, D_MLP),
                        "extra_async_occ": (P10_STALENESS + 1, N_MAIN),
                        "extra_async_birth": (P10_STALENESS + 1, N_MAIN),
                        "extra_async_pbuf": (N_MAIN, D_MLP),
                        "extra_async_pocc": (N_MAIN,),
                        "extra_async_pbirth": (N_MAIN,)},
            aggregation="async", async_buffer=64,
            async_max_staleness=P10_STALENESS, staleness_weight="poly")
        for k, v in launches.items():
            totals[k] += v
        carry = out["last"].carry_state_host()
        same = all(np.array_equal(v, out["full"].carry_state_host()[k])
                   for k, v in carry.items())
        print(f"[async] (e) ring and pool after round 20, resumed vs whole: "
              f"bit_equal={same}", flush=True)
        if not same:
            failures.append("async (e): resumed ring/pool differ")
        time_save_resume(out["last"], out["ck"], smi,
                         "(e) async state: weights + velocity + ring "
                         "(3, 100, 79,510) + pool (100, 79,510)",
                         tag="async")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return totals


# -- phase 11: the beyond-reference defenses ----------------------------------

# The six kernels that port a TPU kernel (the threefry kernel ports none).
SIX_KERNELS = ("pairwise_distances", "pairwise_distances[bf16]",
               "krum_scores", "krum_scores[bf16]", "trimmed_mean", "median",
               "masked_trimmed_mean", "masked_median")
P11_CHECKED = 3                  # rounds 0..2 held against the CPU
P11_SKETCH_BAND = 1e-4           # DnC scores, relative to the largest
# (label, model, dataset, n, mal_prop, defense, attack, rounds, config)
P11_RUNS = (
    ("(a)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "DnC", "alie", ROUNDS,
     {}),
    ("(a)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "GeoMedian", "alie",
     ROUNDS, {}),
    ("(a)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "CenteredClip", "alie",
     ROUNDS, {}),
    ("(a)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "FLTrust", "alie",
     ROUNDS, {}),
    ("(a)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "NormBound", "alie",
     ROUNDS, {}),
    ("(b)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "DnC", "minmax",
     ROUNDS, {}),
    ("(b)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "DnC", "minsum",
     ROUNDS, {}),
    ("(c)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "NormBound",
     "backdoor", ROUNDS, {"backdoor": "pattern"}),
    ("(d)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "FLTrust", "alie",
     ROUNDS, {"grad_dtype": "bfloat16"}),
    ("(e)", "mnist_mlp", "SYNTH_MNIST", N_MAIN, 0.24, "DnC", "alie", ROUNDS,
     {"participation": 0.6}),
    ("(f)", "cifar10_cnn", "SYNTH_CIFAR10_HARD", N_MAIN, 0.24, "FLTrust",
     "alie", ROUNDS, {}),
    ("(f)", "cifar10_cnn", "SYNTH_CIFAR10_HARD", N_MAIN, 0.24,
     "CenteredClip", "alie", ROUNDS, {}),
    ("(g)", "wideresnet40_4", "CIFAR100", 10, 0.2, "GeoMedian", "alie", 3,
     {}),
)


def check_threefry_kernel(peaks, failures):
    """The threefry kernel (csrc/threefry_bits.cu, DnC's sketch bits) at
    the main path's shape: one DnC round at d = 79,510 draws 5 iterations
    x 2 shuffle rounds of d bits in one launch.  The bits must equal the
    plain version's on the card and the host's (utils/threefry.py) bit for
    bit; the sketch drawn on the card must equal the host's choice.
    Returns the kernel's entry of the kernels line."""
    import torch

    from attacking_federate_learning_tpu_torch.defenses import dnc as D
    from attacking_federate_learning_tpu_torch.ops import threefry_bits as R
    from attacking_federate_learning_tpu_torch.utils import threefry

    flops_peak, bytes_peak, _ = peaks
    d, r, iters = D_MLP, 2048, 5
    keys = D.sketch_keys(0, 3, iters)
    subs = []
    for k in keys[:, 0]:
        for _ in range(R.shuffle_rounds(d)):
            k, sub = threefry.split(k)
            subs.append(sub)
    words = torch.from_numpy(np.asarray(subs).astype(np.int64)).cuda()
    K = words.shape[0]
    got = R.threefry_bits(words, d)
    plain = R.threefry_bits_plain(words, d)
    host = np.stack([threefry.random_bits(k, (d,)) for k in subs])
    ok = (torch.equal(got, plain)
          and np.array_equal(got.cpu().numpy(), host.astype(np.int64))
          and torch.equal(got, R.threefry_bits(words, d)))
    idx, _ = D.draw_sketches(0, 3, iters, d, r, "cuda")
    sketch_ok = all(np.array_equal(idx[i].cpu().numpy(),
                                   threefry.choice(keys[i, 0], d, r))
                    for i in range(iters))
    ms = time_ms(lambda: R.threefry_bits(words, d), 50)
    pms = time_ms(lambda: R.threefry_bits_plain(words, d), 10)
    # Bytes: the int64 output (the keys are 16 bytes a row); operations:
    # about 80 integer operations an element, at the fp32 rate
    # (ops/threefry_bits.py:threefry_bits_cost).
    cost = R.threefry_bits_cost(K, d)
    t_b, t_o = cost.bytes / bytes_peak * 1e3, cost.flops / flops_peak * 1e3
    b_ms, b_by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
    draw_ms = time_ms(lambda: D.draw_sketches(0, 3, iters, d, r, "cuda"), 20)
    print(f"[defense kernel] threefry_bits K={K} n={d} (one DnC round's "
          f"shuffle bits) bit_equal_plain_and_host={ok} "
          f"sketch_equals_host_choice={sketch_ok} ms={ms:.4f} "
          f"plain_ms={pms:.4f} library_ms=n/a bound_ms={b_ms:.4f} ({b_by}) "
          f"whole_draw_ms={draw_ms:.4f} (keys on the host, bits, 2 sorts, "
          f"normals)", flush=True)
    if not (ok and sketch_ok):
        failures.append(f"threefry_bits: bit_equal={ok} sketch={sketch_ok}")
    return {"name": "threefry_bits", "route": "cuda",
            "source": f"{PKG}/csrc/threefry_bits.cu",
            "replaces": "attacking_federate_learning_tpu/defenses/dnc.py:88 "
                        "(jax.random.choice, XLA threefry: no TPU kernel)",
            "launches": 0, "max_abs_err": 0.0 if ok else float("inf"),
            "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": [K, d]}


def dnc_iteration_scores(G, f, cfg, rnd):
    """Every DnC iteration's scores of the f32 matrix ``G`` on its device,
    as the defense computes them (defenses/dnc.py:iteration_scores), with
    the keep count and the sketch."""
    from attacking_federate_learning_tpu_torch.defenses import dnc as D

    sc, idx = D.iteration_scores(G, cfg.dnc_iters, cfg.dnc_sketch_dim,
                                 cfg.seed, rnd)
    keep = G.shape[0] - min(int(cfg.dnc_filter_frac * f), G.shape[0] - 1)
    return sc, keep, idx


def checked_new_defense(exp, rounds, excluded, errs, notes):
    """Wraps ``exp.defense_fn`` (DnC, GeoMedian, CenteredClip, FLTrust,
    NormBound) so that for the first ``rounds`` calls the card's aggregate
    is held against the same function on the CPU over the card's wire,
    round index and server gradient.  Bands (f32 eps, n rows, d
    coordinates, |G| the largest wire element):

    - DnC: its survivors' mean, 2 n eps |G|; the sketch drawn on the card
      must equal the host's choice bit for bit, and each iteration's keep
      set the CPU's wherever the gap at its boundary exceeds 1e-4 of the
      largest score (the erfinv start and sums in other orders; a flip
      inside the band is allowed, printed).
    - GeoMedian: iters (2 n + sqrt d) eps |G| (each Weiszfeld step a
      weighted mean of n rows, its weights norms of d-term sums).
    - CenteredClip: iters (2 n + sqrt d) eps 2 |G| (the median anchor
      exact, then clipped means).
    - NormBound: (2 n + 2 sqrt d) eps |G|.
    - FLTrust: (2 n + 4 sqrt d) eps |G| max rescale; its trust weights
      must be zero on both devices, or on neither, wherever the fp64
      cosine is further than 1e-5 from 0.

    (error, ok, band) goes to ``errs``, what else was checked to
    ``notes``, the check's seconds to ``excluded``.  The check's own
    launches on the card (the DnC sketch drawn again) are taken off the
    launch counters: they are no launches of the main path."""
    import torch

    from attacking_federate_learning_tpu_torch.defenses import (
        dnc as D, fltrust as FT
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils import threefry

    eps = float(np.finfo(np.float32).eps)
    inner, defense, cfg = exp.defense_fn, exp.cfg.defense, exp.cfg
    draw = D.draw_sketches

    def checked(grads, n, f, **kw):
        if len(errs) >= rounds:
            return inner(grads, n, f, **kw)
        got = inner(grads, n, f, **kw)
        torch.cuda.synchronize()
        a = time.perf_counter()
        counted = dict(_build.LAUNCHES)
        G = grads.cpu()
        want = inner(G, n, f, **{k: v.cpu() if torch.is_tensor(v) else v
                                 for k, v in kw.items()}).float()
        err = float((got.float().cpu() - want).abs().max())
        big = float(G.float().abs().max())
        d = G.shape[1]
        ok = True
        if defense == "DnC":
            band = 2 * n * eps * big
            timed, D.draw_sketches = D.draw_sketches, draw
            try:
                card, keep, idx = dnc_iteration_scores(grads.float(), f, cfg,
                                                       kw["round"])
                cpu, _, _ = dnc_iteration_scores(G.float(), f, cfg,
                                                 kw["round"])
            finally:
                D.draw_sketches = timed
            flips = 0
            if idx is not None:
                keys = D.sketch_keys(cfg.seed, kw["round"], len(card))
                ok &= all(np.array_equal(idx[i].cpu().numpy(),
                                         threefry.choice(keys[i, 0], d,
                                                         idx.shape[1]))
                          for i in range(len(card)))
            for sc, sp in zip(card, cpu):
                sc, sp = sc.cpu().double(), sp.double()
                sband = P11_SKETCH_BAND * float(sp.max())
                ok &= bool(((sc - sp).abs() <= sband).all())
                kc = torch.sort(sc.float(), stable=True).indices[:keep]
                kp = torch.sort(sp.float(), stable=True).indices[:keep]
                if set(kc.tolist()) != set(kp.tolist()):
                    srt = torch.sort(sp).values
                    gap = float(srt[keep] - srt[keep - 1])
                    flips += 1
                    ok &= gap <= 2 * sband
            notes.append(f"r{kw['round']}: sketch_equals_host=True "
                         f"keep_set_flips_in_band={flips}" if ok else
                         f"r{kw['round']}: DnC sketch or keep sets differ")
        elif defense == "GeoMedian":
            band = cfg.geomed_iters * (2 * n + math.sqrt(d)) * eps * big
        elif defense == "CenteredClip":
            band = cfg.cclip_iters * (2 * n + math.sqrt(d)) * eps * 2 * big
        elif defense == "NormBound":
            band = (2 * n + 2 * math.sqrt(d)) * eps * big
        else:  # FLTrust
            g0 = kw["server_grad"]
            ts_c, sc_c = FT.trust_scores(grads, g0)
            ts_p, sc_p = FT.trust_scores(G, g0.cpu())
            band = (2 * n + 4 * math.sqrt(d)) * eps * big * float(
                sc_p.max())
            G64, g64 = G.double(), g0.cpu().double()
            cos64 = (G64 @ g64) / (G64.norm(dim=1) * g64.norm())
            decisive = cos64.abs() > 1e-5
            same = (ts_c.cpu() > 0) == (ts_p > 0)
            ok &= bool(same[decisive].all())
            notes.append(f"r{len(errs)}: trusted {int((ts_c > 0).sum())}/"
                         f"{n}, decisive {int(decisive.sum())}, trust "
                         f"decisions equal={bool(same[decisive].all())}")
        errs.append((err, ok and err <= band, band))
        _build.LAUNCHES.update(counted)
        excluded.append(time.perf_counter() - a)
        return got

    exp.defense_fn = checked


def run_defense_path(ds_mnist, failures, smi):
    """Phase 11: the beyond-reference defenses through run() at full width
    (P11_RUNS), then (h) DnC preempted at round 10 and resumed.  Returns
    launches per kernel summed over the runs."""
    import tempfile

    import torch

    from attacking_federate_learning_tpu_torch.attacks import make_attacker
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.defenses import dnc as D
    from attacking_federate_learning_tpu_torch.ops import _build

    totals = {name: 0 for name in _build.LAUNCHES}
    sets = {"SYNTH_MNIST": ds_mnist}
    for (label, model, dataset, n, mal_prop, defense, attack, rounds,
         extra) in P11_RUNS:
        if dataset not in sets:
            t0 = time.perf_counter()
            sets[dataset] = load_dataset(dataset, seed=0, synth_train=50_000,
                                         synth_test=10_000)
            print(f"[defense] {dataset} 50000/10000 made in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        ds = sets[dataset]
        cfg = ExperimentConfig(
            dataset=dataset, model=model, users_count=n, mal_prop=mal_prop,
            batch_size=128, epochs=rounds, num_std=1.5, learning_rate=0.1,
            momentum=0.9, defense=defense,
            test_step=TEST_STEP if rounds == ROUNDS else rounds - 1,
            synth_train=50_000 if dataset != "SYNTH_MNIST" else 60_000,
            synth_test=10_000, **extra)
        exp = FederatedExperiment(cfg, make_attacker(cfg, ds, name=attack,
                                                     device="cuda"),
                                  ds, device="cuda")
        kernels = {"DnC": ("threefry_bits",),
                   "CenteredClip": ("median",)}.get(defense, ())
        banned = tuple(k for k in _build.LAUNCHES if k not in kernels)
        excluded, errs, notes = [], [], []
        checked_new_defense(exp, P11_CHECKED, excluded, errs, notes)
        draw_ev, draw_host, sg_ev = [], [], []
        real_draw = D.draw_sketches

        def timed_draw(*args, real_draw=real_draw, draw_ev=draw_ev,
                       draw_host=draw_host):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            h = time.perf_counter()
            a.record()
            out = real_draw(*args)
            b.record()
            draw_host.append(time.perf_counter() - h)
            draw_ev.append((a, b))
            return out

        if defense == "FLTrust":
            real_sg = exp.server_grad

            def timed_sg(real_sg=real_sg, sg_ev=sg_ev):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = real_sg()
                b.record()
                sg_ev.append((a, b))
                return out

            exp.server_grad = timed_sg
        craft_ev = time_crafts(exp.attacker) if attack == "backdoor" else []
        D.draw_sketches = timed_draw
        try:
            run = drive(exp, kernels, banned, failures,
                        f"defense {label} {model} {attack} {defense}",
                        excluded)
        finally:
            D.draw_sketches = real_draw
        for name, count in run["launches"].items():
            totals[name] += count
        torch.cuda.synchronize()
        beside = ""
        if defense == "CenteredClip" and run["launches"]["median"] != rounds:
            failures.append(f"defense {label} CenteredClip: median launched "
                            f"{run['launches']['median']} times in {rounds} "
                            f"rounds (want one a round)")
        if defense == "DnC":
            per = run["launches"]["threefry_bits"] / rounds
            beside += (f"draw_device_ms={statistics.median(a.elapsed_time(b) for a, b in draw_ev):.3f} "
                       f"draw_host_ms={1e3 * statistics.median(draw_host):.3f} "
                       f"threefry_launches_per_round={per:.0f} ")
        if sg_ev:
            beside += (f"server_grad_ms={statistics.median(a.elapsed_time(b) for a, b in sg_ev):.3f} "
                       f"pool_rows={len(exp.metadata[1])} ")
        if craft_ev:
            asr = run["result"]["asr"]
            beside += (f"asr r0/r10/r20 = {'/'.join(f'{x:.2f}' for x in asr)}"
                       f" % craft_ms={statistics.median(a.elapsed_time(b) for a, b in craft_ev):.3f} ")
            if not backdoor_lines_ok(run["lines"], asr):
                failures.append(f"defense {label}: BEFORE/Test set/POST "
                                f"lines {run['lines']}")
        agg_ok = len(errs) == P11_CHECKED and all(ok for _, ok, _ in errs)
        if not agg_ok:
            failures.append(f"defense {label} {model} {defense}: aggregates "
                            f"vs CPU {errs} {notes}")
        evals = "/".join(f"r{x}" for x in eval_rounds(cfg))
        knob = "".join(f" {k}={v}" for k, v in extra.items()
                       if k != "backdoor")
        print(f"[defense] {label} {model:14s} {attack:8s} {defense:12s}"
              f"{knob} n={n} f={exp.f} d={exp.flat.dim} acc {evals} = "
              f"{run['acc_txt']} % median_round_ms={run['median_ms']:.3f} "
              f"deliver_ms={run['deliver_ms']:.3f} peak_GiB="
              f"{run['peak_gib']:.2f} {beside}agg_vs_cpu="
              f"{[(float(f'{e:.3e}'), o, float(f'{b:.2e}')) for e, o, b in errs]} "
              f"{' '.join(notes)} launches="
              f"{ {k: v for k, v in run['launches'].items() if v} } "
              f"finite={run['finite']} on {smi}", flush=True)
        for line in run["lines"]:
            if line.startswith(("Test set", "##Test")):
                print(f"[defense]   {line.strip()}", flush=True)
        if label == "(a)" and defense in ("DnC", "FLTrust"):
            profile_round(exp, f"{defense}", top=4, tag="defense")
        del exp, run
        gc.collect()
        torch.cuda.empty_cache()
    del sets
    gc.collect()
    # -- (h) DnC preempted at round 10 and resumed --------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p11_") as root:
        launches, out = p9_triplet(
            ds_mnist, "(h) DnC preempt/resume", "DnC", 0.24, False,
            ("threefry_bits",), SIX_KERNELS, failures, root, tag="defense")
        for k, v in launches.items():
            totals[k] += v
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return totals


# -- phase 12: population & traffic ------------------------------------------

# The kernel each defense launches on the traffic path (masked: the
# arrival mask always reaches it).
TRAFFIC_KERNELS = {"Krum": ("pairwise_distances",),
                   "TrimmedMean": ("masked_trimmed_mean",),
                   "Median": ("masked_median",), "NoDefense": ()}
P12_LADDER = dict(population=150, rate=0.75, reliability_lo=0.3,
                  reliability_hi=0.6, churn_dwell=2)
# (label, defense, mal_prop, traffic, faulted)
P12_RUNS = (
    ("(a) large population", "Krum", 0.24,
     dict(population=100_000, diurnal_amp=0.5), False),
    ("(b) unreliable", "Krum", 0.24, P12_LADDER, False),
    ("(c) faulted", "TrimmedMean", 0.1, dict(population=1000), True),
    ("(d) sybil burst", "Median", 0.24,
     dict(population=1000, sybil_burst_period=4, sybil_burst_width=1),
     False),
)


def run_traffic_path(ds, failures, smi):
    """Phase 12: population & traffic through run() at phase 5's width
    (P12_RUNS), then (e) async k = 64 with the latency profile and (f)
    (b) preempted and resumed.  Returns launches per kernel summed over
    the runs."""
    import collections
    import dataclasses
    import tempfile

    import torch

    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        FaultConfig, TrafficConfig
    )
    from attacking_federate_learning_tpu_torch.core import async_rounds as A
    from attacking_federate_learning_tpu_torch.core import population as P
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.metrics import (
        iter_events
    )

    totals = {name: 0 for name in _build.LAUNCHES}
    for label, defense, mal_prop, traffic, faulted in P12_RUNS:
        cfg = main_config(defense, mal_prop,
                          FaultConfig(**FAULTS_MAIN) if faulted else None,
                          traffic=TrafficConfig(**traffic))
        plan_s = []
        for t in range(cfg.epochs):
            a = time.perf_counter()
            P.traffic_schedule(P.PopulationRegistry(cfg.traffic, N_MAIN,
                                                    cfg.corrupted_count,
                                                    cfg.seed),
                               t, 1, N_MAIN, cfg.corrupted_count,
                               defense, cfg.traffic.fallback_defense,
                               cfg.traffic.min_cohort)
            plan_s.append(time.perf_counter() - a)
        want = P.replay_traffic(cfg, cfg.epochs)
        actions = collections.Counter(e["action"] for e in want)
        exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                  device="cuda")
        fb = cfg.traffic.fallback_defense
        may = set(TRAFFIC_KERNELS[defense])
        if actions["fallback"]:
            may |= set(TRAFFIC_KERNELS[fb])
        kernels = tuple(TRAFFIC_KERNELS[defense]) if actions["remask"] else ()
        banned = tuple(k for k in _build.LAUNCHES if k not in may)
        excluded, errs, dist_errs, fb_errs, fb_dist = [], [], [], [], []
        checked_defense(exp, P11_CHECKED, excluded, errs, dist_errs)
        checked_defense(exp, P11_CHECKED, excluded, fb_errs, fb_dist,
                        attr="_traffic_fallback_fn", defense=fb)
        inner = exp.run_round
        per_round, holds = [], []

        def observed(t, inner=inner, per_round=per_round, holds=holds):
            a = time.perf_counter()
            before = dict(_build.LAUNCHES)
            w0 = exp.state.weights.clone()
            v0 = exp.state.velocity.clone()
            excluded.append(time.perf_counter() - a)
            out = inner(t)
            a = time.perf_counter()
            action = exp._traffic_events[t]["action"]
            ran = {k for k, v in _build.LAUNCHES.items() if v > before[k]}
            want_k = set({"remask": TRAFFIC_KERNELS[defense],
                          "fallback": TRAFFIC_KERNELS[fb],
                          "hold": ()}[action])
            per_round.append((t, action, ran == want_k))
            if action == "hold":
                holds.append(torch.equal(out.weights, w0)
                             and torch.equal(out.velocity, v0)
                             and out.round == t + 1)
            excluded.append(time.perf_counter() - a)
            return out

        exp.run_round = observed
        run = drive(exp, kernels, banned, failures,
                    f"traffic {label} {defense}", excluded)
        for name, count in run["launches"].items():
            totals[name] += count
        events_ok = run["result"]["traffic"] == want
        kernels_ok = all(ok for _, _, ok in per_round)
        holds_ok = all(holds) and len(holds) == actions["hold"]
        agg_ok = (all(ok for _, ok in errs + fb_errs + dist_errs + fb_dist)
                  and len(errs) + len(fb_errs) >= min(
                      P11_CHECKED, actions["remask"] + actions["fallback"]))
        ladder_ok = label != "(b) unreliable" or len(actions) == 3
        f_eff = [e["f_eff"] for e in want]
        sybil_ok = label != "(d) sybil burst" or all(
            (x == 0) == (t % 4 != 0) for t, x in enumerate(f_eff))
        if not (events_ok and kernels_ok and holds_ok and agg_ok
                and ladder_ok and sybil_ok):
            failures.append(
                f"traffic {label}: events_equal_replay={events_ok} "
                f"kernels_per_action={[x for x in per_round if not x[2]]} "
                f"holds={holds} aggregates {errs} {fb_errs} distances "
                f"{dist_errs} {fb_dist} actions={dict(actions)} "
                f"sybil f_eff={f_eff}")
        print(f"[traffic] {label:20s} {defense:11s} f={exp.f} P="
              f"{cfg.traffic.population} acc r0/r10/r20 = {run['acc_txt']} "
              f"% median_round_ms={run['median_ms']:.3f} deliver_ms="
              f"{run['deliver_ms']:.3f} peak_GiB={run['peak_gib']:.2f} "
              f"schedule_host_ms={1e3 * statistics.median(plan_s):.3f} "
              f"actions={dict(actions)} arrived="
              f"{[e['arrived'] for e in want]} f_eff={f_eff} "
              f"events_equal_replay={events_ok} kernels_per_action_ok="
              f"{kernels_ok} hold_rounds_bit_equal={holds} agg_vs_cpu="
              f"{[(float(f'{e:.3e}'), o) for e, o in errs + fb_errs]} "
              + (f"fault_counts_match_replay={run['counts_ok']} "
                 if faulted else "")
              + f"launches={ {k: v for k, v in run['launches'].items() if v} }"
              f" finite={run['finite']} on {smi}", flush=True)
        del exp, run
        gc.collect()
        torch.cuda.empty_cache()
    # -- (e) async k = 64 with the latency profile --------------------------
    traffic = TrafficConfig(population=100_000, latency_scale=1.0,
                            latency_tail=1.5)
    cfg = async_config("TrimmedMean", 0.24, 64, "poly", False,
                       traffic=traffic)
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cuda")
    assert exp._traffic_latency is not None
    kernels = ("masked_trimmed_mean",)
    banned = tuple(k for k in _build.LAUNCHES if k not in kernels)
    excluded, errs, dist_errs, twin_ok, step_s = [], [], [], [], []
    checked_defense(exp, P10_CHECKED, excluded, errs, dist_errs)
    undo = async_twin(exp, excluded, twin_ok, step_s)
    try:
        run = drive(exp, kernels, banned, failures,
                    "traffic (e) async latency", excluded)
    finally:
        undo()
    for name, count in run["launches"].items():
        totals[name] += count
    rows = run["result"]["async"]
    replay_ok = replay_matches(rows, cfg, exp)
    uniform = A.replay_schedule(dataclasses.replace(cfg, traffic=None),
                                exp.m, exp.m_mal, cfg.epochs)
    latency_used = [r["staleness_hist"] for r in rows] != [
        r["staleness_hist"] for r in uniform]
    scales, tail = exp._traffic_latency
    delays = [A.draw_delays(exp._async_key, t, exp.m, exp.m_mal,
                            exp.async_spec, latency=(scales, tail))[0]
              for t in range(cfg.epochs)]
    delays_ok = all(np.array_equal(dl, P.traffic_delays(
        exp._async_key, t, scales, tail, exp.async_spec.depth))
        for t, dl in enumerate(delays))
    ok = (replay_ok and latency_used and delays_ok
          and all(o for _, o in twin_ok) and len(twin_ok) == P10_CHECKED
          and all(o for _, o in errs))
    if not ok:
        failures.append(f"traffic (e) async latency: replay_ok={replay_ok} "
                        f"latency_used={latency_used} delays={delays_ok} "
                        f"step vs CPU {twin_ok} aggregates {errs}")
    hist = np.sum([r["staleness_hist"] for r in rows], axis=0)
    print(f"[traffic] (e) async latency TrimmedMean poly k=64 acc r0/r10/r20"
          f" = {run['acc_txt']} % median_round_ms={run['median_ms']:.3f} "
          f"deliver_ms={run['deliver_ms']:.3f} peak_GiB="
          f"{run['peak_gib']:.2f} step_host_ms="
          f"{1e3 * statistics.median(step_s):.3f} delivered_rounds="
          f"{sum(r['delivered'] > 0 for r in rows)}/{len(rows)} "
          f"staleness_hist={hist.tolist()} replay_ok={replay_ok} "
          f"differs_from_uniform={latency_used} delays_equal_host={delays_ok}"
          f" step_vs_cpu_ok={all(o for _, o in twin_ok)} agg_vs_cpu="
          f"{[(float(f'{e:.3e}'), o) for e, o in errs]} launches="
          f"{ {k: v for k, v in run['launches'].items() if v} } on {smi}",
          flush=True)
    del exp, run
    gc.collect()
    torch.cuda.empty_cache()
    # -- (f) (b) preempted and resumed --------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_") as root:
        launches, out = p9_triplet(
            ds, "(f) traffic ladder resume", "Krum", 0.24, False,
            ("pairwise_distances",),
            tuple(k for k in _build.LAUNCHES
                  if k not in ("pairwise_distances", "masked_median")),
            failures, root, tag="traffic",
            traffic=TrafficConfig(**P12_LADDER))
        for k, v in launches.items():
            totals[k] += v
        cfg = out["full"].cfg
        keys = ("round", "arrived", "f_eff", "cohort", "action", "defense")
        got = [{k: e[k] for k in keys} for e in iter_events(
            os.path.join(root, "two", "logs", "p9.jsonl"))
            if e["kind"] == "traffic"]
        want = P.replay_traffic(cfg, cfg.epochs)
        print(f"[traffic] (f) stitched traffic events over both attempts "
              f"equal the replay (each round once): {got == want}",
              flush=True)
        if got != want:
            failures.append("traffic (f): stitched events differ from the "
                            "replay")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return totals


# -- phase 13: the hierarchical round --------------------------------------------
N_HIER, M_HIER, B_HIER = 1000, 100, 32   # S = 10; f = 240: f1 = 24, f2 = 3
N_HIER_E = 10_000                        # (e): S = 100; f1 = f2 = 24
P13_ROUNDS = 6                           # rounds 0..5, evaluated at 0 and 5
P13_CHECKED = 2        # tier-1 calls, and tier-2 calls, held against the CPU
# Launches of one defense call over an unmasked matrix (both tiers of a
# clean round) and over a masked one (faulted rounds: tier 1 with the
# quarantine mask, tier 2 with the alive counts).
HIER_UNMASKED = {"NoDefense": {}, "Krum": {"krum_scores": 1},
                 "TrimmedMean": {"trimmed_mean": 1},
                 "Median": {"median": 1},
                 "Bulyan": {"pairwise_distances": 1, "trimmed_mean": 1}}
HIER_MASKED = {"NoDefense": {}, "Krum": {"pairwise_distances": 1},
               "TrimmedMean": {"masked_trimmed_mean": 1},
               "Median": {"masked_median": 1},
               "Bulyan": {"pairwise_distances": 1,
                          "masked_trimmed_mean": 1}}
# (a): (label, tier 1, tier 2, placement)
P13_RUNS = (
    ("(a) Krum/Krum", "Krum", "Krum", "spread"),
    ("(a) Bulyan/TrimmedMean", "Bulyan", "TrimmedMean", "spread"),
    ("(a) TrimmedMean/Median", "TrimmedMean", "Median", "spread"),
    ("(a) Median/Median", "Median", "Median", "spread"),
    ("(a) NoDefense/NoDefense", "NoDefense", "NoDefense", "spread"),
    ("(a) Krum/Krum concentrated", "Krum", "Krum", "concentrated"),
)
# (b): seed 4's plan over rounds 0..7 (hier_fault_schedule and
# plan_tier2_actions on the host): remask, hold, hold, fallback, remask,
# fallback, fallback, fallback; 9, 5, 5, 7, 9, 7, 7, 8 shards alive.
P13_FAULTS = dict(dropout=0.1, corrupt=0.05, corrupt_mode="nan",
                  shard_dropout=0.2, shard_dropout_dwell=2, straggler=0.1,
                  straggler_delay=2, seed=4)
P13_FAULT_ROUNDS, P13_RESUME_AT = 8, 4


def hier_config(defense, tier2, placement="spread", n=N_HIER,
                epochs=P13_ROUNDS, test_step=5, synth_train=60_000, **kw):
    """Phase 13's configuration: mnist_mlp at phase 5's width, mal_prop
    0.24, megabatches of 100 clients, batch 32 (every client of n = 1,000
    holds 60 of the 60,000 images, of n = 10,000 the 32 of 320,000)."""
    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(
        dataset=C.SYNTH_MNIST, users_count=n, mal_prop=0.24,
        batch_size=B_HIER, epochs=epochs, num_std=1.5, learning_rate=0.1,
        momentum=0.9, defense=defense, test_step=test_step,
        synth_train=synth_train, synth_test=10_000,
        aggregation="hierarchical", megabatch=M_HIER, tier2_defense=tier2,
        mal_placement=placement, **kw)


def hier_expected(exp, action):
    """Launches per kernel one round of ``exp`` must make: S tier-1 calls
    and one tier-2 call (the configured tier-2 defense under 'remask', the
    masked shard median under 'fallback', none under 'hold')."""
    table = HIER_MASKED if exp.faults is not None else HIER_UNMASKED
    S = exp._placement.num_shards
    want = {k: S * v for k, v in table[exp.cfg.defense].items()}
    tier2 = (exp._tier2_name, "Median", None)[action]
    for k, v in (table[tier2].items() if tier2 else ()):
        want[k] = want.get(k, 0) + v
    return want


def hier_drive(exp, failures, label):
    """One phase-13 run through ``drive``: the first P13_CHECKED tier-1
    calls and tier-2 calls (the fallback's too) held against the plain
    versions on the CPU (``checked_defense``'s bands), each round's
    launches equal to :func:`hier_expected` of its action, a hold round's
    weights and velocity bit for bit, the round's device time from CUDA
    events.  Returns drive's result, the rounds' records, the CPU errors
    and the device round ms."""
    import torch

    from attacking_federate_learning_tpu_torch.ops import _build

    excluded, errs, dist_errs, t2_errs, t2_dist = [], [], [], [], []
    checked_defense(exp, P13_CHECKED, excluded, errs, dist_errs)
    checked_defense(exp, P13_CHECKED, excluded, t2_errs, t2_dist,
                    attr="_tier2_fn", defense=exp._tier2_name)
    if exp.faults is not None:
        checked_defense(exp, P13_CHECKED, excluded, t2_errs, t2_dist,
                        attr="_tier2_fallback_fn", defense="Median")
    per_round, inner = [], exp.run_round

    def observed(t):
        a = time.perf_counter()
        before = dict(_build.LAUNCHES)
        w0, v0 = exp.state.weights.clone(), exp.state.velocity.clone()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        excluded.append(time.perf_counter() - a)
        ev[0].record()
        out = inner(t)
        ev[1].record()
        a = time.perf_counter()
        action = (0 if exp.faults is None
                  else exp.last_round_faults["tier2_action"])
        got = {k: v - before[k] for k, v in _build.LAUNCHES.items()
               if v > before[k]}
        hold_ok = action != 2 or (torch.equal(out.weights, w0)
                                  and torch.equal(out.velocity, v0)
                                  and out.round == t + 1)
        per_round.append({"t": t, "action": action, "launches": got,
                          "ok": got == hier_expected(exp, action)
                          and hold_ok, "ev": ev})
        excluded.append(time.perf_counter() - a)
        return out

    exp.run_round = observed
    actions = {0} if exp.faults is None else {0, 1, 2}
    may = set()
    for act in actions:
        may |= set(hier_expected(exp, act))
    kernels = tuple(hier_expected(exp, 0))
    banned = tuple(k for k in _build.LAUNCHES if k not in may)
    run = drive(exp, kernels, banned, failures, f"hier {label}", excluded)
    dev_ms = statistics.median(r["ev"][0].elapsed_time(r["ev"][1])
                               for r in per_round)
    bad = [(r["t"], r["action"], r["launches"]) for r in per_round
           if not r["ok"]]
    cpu = errs + t2_errs + dist_errs + t2_dist
    if bad or not all(ok for _, ok in cpu) or len(errs) < P13_CHECKED:
        failures.append(f"hier {label}: rounds with other launches than "
                        f"their defenses' {bad}; aggregates vs CPU {errs} "
                        f"tier 2 {t2_errs} distances {dist_errs} {t2_dist}")
    return run, per_round, errs + t2_errs, dev_ms


def hier_line(tag, label, exp, run, per_round, errs, dev_ms, smi, extra=""):
    S = exp._placement.num_shards
    print(f"[hier] {tag} {label:26s} n={exp.n} S={S} f={exp.f} "
          f"f1={exp._tier1_f} f2={exp._tier2_f} mal_counts[:3]="
          f"{list(exp._placement.mal_counts[:3])} acc={run['acc_txt']} % "
          f"median_round_ms={run['median_ms']:.3f} (host clock) "
          f"device_round_ms={dev_ms:.3f} (CUDA events) "
          f"deliver_ms={run['deliver_ms']:.3f} per megabatch "
          f"peak_GiB={run['peak_gib']:.3f} launches_round_1="
          f"{per_round[min(1, len(per_round) - 1)]['launches']} "
          f"launches_ok={all(r['ok'] for r in per_round)} agg_vs_cpu="
          f"{[(float(f'{e:.3e}'), o) for e, o in errs]} {extra}"
          f"finite={run['finite']} on {smi}", flush=True)


def check_hier_kernels(failures, smi):
    """Each kernel of the hierarchical path against its plain version on
    the card at the tier-1 shape (100, 79,510), f1 = 24, and at tier 2's
    (10, 79,510), f2 = 3 (the sort route pads 10 rows to 32), unmasked
    and masked: tier 1 with a drawn quarantine mask, tier 2 with the
    mask of alive counts that lost two shards.  Distances within phase
    3's d^2 band, symmetric with a zero diagonal; Krum's scores within
    the band's sum and its winner exact or tied within it; the medians
    exact; the trimmed means within k rounding steps of the largest |g|
    (2x margin)."""
    import torch

    from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
        krum_scores, krum_scores_plain, masked_median, masked_median_plain,
        masked_trimmed_mean, masked_trimmed_mean_plain, median_of,
        median_of_plain, trimmed_mean_of, trimmed_mean_of_plain
    )
    from attacking_federate_learning_tpu_torch.ops.distances import (
        pairwise_distances, pairwise_distances_plain
    )

    eps = float(np.finfo(np.float32).eps)
    alive = torch.tensor([100, 0, 97, 100, 100, 0, 99, 100, 100, 98])
    shapes = (("tier 1", 100, 24, torch.from_numpy(drawn_mask(100, 3, 24))),
              ("tier 2", 10, 3, alive > 0))
    for tier, n, f, mask in shapes:
        G = torch.from_numpy(cohort(n, D_MLP, f, "alie", 40 + n)).cuda()
        mask = mask.cuda()
        e = int(mask.sum())
        G64 = G.double()
        sq64 = (G64 * G64).sum(1)
        band = d2_band(sq64, kernel_chain(D_MLP)) + d2_band(sq64, D_MLP)
        D = pairwise_distances(G)
        Dp = pairwise_distances_plain(G)
        checks = [("pairwise_distances",
                   float((D - Dp).abs().max()),
                   bool(((D.double() ** 2 - Dp.double() ** 2).abs()
                         <= band).all()) and bool((D == D.T).all())
                   and bool((D.diagonal() == 0).all()),
                   lambda: pairwise_distances(G),
                   lambda: pairwise_distances_plain(G))]
        (gs, gr), (ws, wr) = krum_scores(G, f), krum_scores_plain(G, f)
        eij = torch.minimum(band.sqrt(), band / Dp.double().clamp(
            min=1e-30)).sum(1)
        tol = eij + 2.0 * n * eps * wr.double().abs()
        ga, wa = int(torch.argmin(gs)), int(torch.argmin(ws))
        ok = (bool(((gs.double() - ws.double()).abs() <= 2 * tol).all())
              and bool(((gr.double() - wr.double()).abs() <= tol).all())
              and (ga == wa or abs(float(ws[ga] - ws[wa]))
                   <= float(2 * (tol[ga] + tol[wa]))))
        checks.append(("krum_scores", float((gs - ws).abs().max()), ok,
                       lambda: krum_scores(G, f),
                       lambda: krum_scores_plain(G, f)))
        k = n - f - 1
        atol = 2.0 * k * eps * float(G.abs().max())
        got, want = trimmed_mean_of(G, k), trimmed_mean_of_plain(G, k)
        checks.append(("trimmed_mean", *close(got, want, atol, 1e-6),
                       lambda: trimmed_mean_of(G, k),
                       lambda: trimmed_mean_of_plain(G, k)))
        checks.append(("median", *exact(median_of(G), median_of_plain(G)),
                       lambda: median_of(G), lambda: median_of_plain(G)))
        got = masked_trimmed_mean(G, mask, f + 1)
        want = masked_trimmed_mean_plain(G, mask, f + 1)
        atol = 2.0 * e * eps * float(G[mask].abs().max())
        checks.append(("masked_trimmed_mean", *close(got, want, atol, 1e-6),
                       lambda: masked_trimmed_mean(G, mask, f + 1),
                       lambda: masked_trimmed_mean_plain(G, mask, f + 1)))
        checks.append(("masked_median",
                       *exact(masked_median(G, mask),
                              masked_median_plain(G, mask)),
                       lambda: masked_median(G, mask),
                       lambda: masked_median_plain(G, mask)))
        for name, err, ok, fn, plain in checks:
            print(f"[hier kernel] {name:19s} {tier} ({n}, {D_MLP}) f={f} "
                  f"alive={e} max_abs_err={err:.3e} ok={ok} "
                  f"ms={time_ms(fn, 5):.4f} plain_ms={time_ms(plain, 5):.4f}"
                  f" on {smi}", flush=True)
            if not ok:
                failures.append(f"hier kernel {name} {tier}: max_abs_err "
                                f"{err:.3e}")


def run_hier_path(ds, failures, smi):
    """Phase 13: the hierarchical round through run() at mnist_mlp's
    width: (a) P13_RUNS at n = 1,000, S = 10; (b) faulted TrimmedMean /
    Krum walking the tier-2 ladder, then a checkpoint and a bit-equal
    resume; (c) Krum / Krum over 100,000 clients (slot resampling); (d)
    the backdoor; (e) Bulyan / Bulyan at n = 10,000, S = 100, its peak
    above the resting state under 1 GB.  Returns launches per kernel
    summed over the runs."""
    import tempfile

    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import (
        DriftAttack, make_attacker
    )
    from attacking_federate_learning_tpu_torch.config import (
        FaultConfig, TrafficConfig
    )
    from attacking_federate_learning_tpu_torch.core import population as P
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.core.faults import (
        hier_round_faults
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.checkpoint import (
        Checkpointer
    )

    t_phase = time.perf_counter()
    totals = {name: 0 for name in _build.LAUNCHES}

    def add(run):
        for k, v in run["launches"].items():
            totals[k] += v

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    check_hier_kernels(failures, smi)
    # -- (a) the tier pairs ---------------------------------------------------
    for label, t1, t2, placement in P13_RUNS:
        cfg = hier_config(t1, t2, placement)
        exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                  device="cuda")
        run, per_round, errs, dev_ms = hier_drive(exp, failures, label)
        add(run)
        hier_line("(a)", label[4:], exp, run, per_round, errs, dev_ms, smi)
        del exp, run
        release()
    # -- (b) faults, the ladder, a checkpoint and a resume -------------------
    cfg = hier_config("TrimmedMean", "Krum", epochs=P13_FAULT_ROUNDS,
                      test_step=4, faults=FaultConfig(**P13_FAULTS))
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cuda")
    draw_s = []
    for t in range(cfg.epochs):
        a = time.perf_counter()
        hier_round_faults(exp._fault_key, t, exp._placement, exp.faults)
        draw_s.append(time.perf_counter() - a)
    run, per_round, errs, dev_ms = hier_drive(exp, failures,
                                              "(b) faulted TrimmedMean/Krum")
    add(run)
    actions = [r["action"] for r in per_round]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p13_") as root:
        first = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                    device="cuda")
        for t in range(P13_RESUME_AT):
            first.run_round(t)
        ck = Checkpointer(cfg, run_dir=root)
        a = time.perf_counter()
        path = ck.save_auto(first.state, extra=first.carry_state_host())
        save_ms = 1e3 * (time.perf_counter() - a)
        nbytes = os.path.getsize(path)
        del first
        release()
        second = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                     device="cuda")
        a = time.perf_counter()
        second.state, extra = ck.resume(path, with_extra=True,
                                        device="cuda")
        second.restore_carry_state(extra)
        resume_ms = 1e3 * (time.perf_counter() - a)
        ring_shape = tuple(second.fault_state["stale"].shape)
        for t in range(P13_RESUME_AT, cfg.epochs):
            second.run_round(t)
        resumed_ok = (torch.equal(second.state.weights, exp.state.weights)
                      and torch.equal(second.state.velocity,
                                      exp.state.velocity)
                      and torch.equal(second.fault_state["stale"],
                                      exp.fault_state["stale"]))
        del second, extra
    ladder_ok = set(actions) == {0, 1, 2} and actions == run.get("actions")
    if not (ladder_ok and resumed_ok and run["counts_ok"]):
        failures.append(f"hier (b): actions {actions} (plan "
                        f"{run.get('actions')}), events = replay "
                        f"{run['counts_ok']}, resume bit-equal {resumed_ok}")
    hier_line("(b)", "faulted TrimmedMean/Krum", exp, run, per_round, errs,
              dev_ms, smi,
              f"actions={actions} shards_alive="
              f"{[r['shards_alive'] for r in run['result']['faults']]} "
              f"fault_events_equal_replay={run['counts_ok']} "
              f"draw_host_ms={1e3 * statistics.median(draw_s):.3f} "
              f"ring={ring_shape} checkpoint_bytes={nbytes} save_ms="
              f"{save_ms:.1f} resume_ms={resume_ms:.1f} resumed_at="
              f"{P13_RESUME_AT} bit_equal={resumed_ok} ")
    del exp, run
    release()
    # -- (c) slot resampling over 100,000 clients ----------------------------
    cfg = hier_config("Krum", "Krum", epochs=4, test_step=3,
                      traffic=TrafficConfig(population=100_000))
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cuda")
    parts, grads_fn = [], exp.compute_grads

    def recorded(t, part=None, grads_fn=grads_fn):
        parts.append(part)
        return grads_fn(t, part)

    exp.compute_grads = recorded
    run, per_round, errs, dev_ms = hier_drive(exp, failures,
                                              "(c) Krum/Krum P=100,000")
    add(run)
    place, slot_s = exp._placement, []
    want = []
    for t in range(cfg.epochs):
        a = time.perf_counter()
        want.append(np.stack([P.resample_slots(
            exp._traffic_key, t, place.grid[s].astype(np.int64),
            place.mal_counts[s], exp.f, exp.n)
            for s in range(place.num_shards)]))
        slot_s.append(time.perf_counter() - a)
    used = torch.stack(parts).cpu().numpy().reshape(
        cfg.epochs, place.num_shards, place.megabatch)
    slots_ok = np.array_equal(used, np.stack(want))
    if not slots_ok:
        failures.append("hier (c): the device's slots differ from the "
                        "host's draw")
    hier_line("(c)", "Krum/Krum P=100,000", exp, run, per_round, errs,
              dev_ms, smi,
              f"slots_equal_host_draw={slots_ok} slot_draw_host_ms="
              f"{1e3 * statistics.median(slot_s):.3f} ")
    del exp, run, parts
    release()
    # -- (d) the backdoor, once per megabatch ----------------------------------
    cfg = hier_config("TrimmedMean", "TrimmedMean", epochs=3, test_step=1,
                      backdoor="pattern")
    att = make_attacker(cfg, dataset=ds, device="cuda")
    crafts, craft = [], att.craft

    def timed_craft(mal, ctx, craft=craft):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = craft(mal, ctx)
        b.record()
        crafts.append((a, b, mal.shape[0], ctx.check_finite))
        return out

    att.craft = timed_craft
    exp = FederatedExperiment(cfg, att, ds, device="cuda")
    run, per_round, errs, dev_ms = hier_drive(exp, failures,
                                              "(d) backdoor")
    add(run)
    craft_ms = statistics.median(a.elapsed_time(b) for a, b, _, _ in crafts)
    crafts_ok = [(c, chk) for _, _, c, chk in crafts] == [
        (c, False) for c in exp._placement.mal_counts if c] * cfg.epochs
    lines_ok = backdoor_lines_ok(run["lines"], run["result"]["asr"])
    if not (crafts_ok and lines_ok):
        failures.append(f"hier (d): crafts per megabatch ok={crafts_ok}, "
                        f"lines ok={lines_ok}")
    hier_line("(d)", "backdoor TrimmedMean", exp, run, per_round, errs,
              dev_ms, smi,
              f"crafts={len(crafts)} craft_ms={craft_ms:.3f} "
              f"early_outs={att.early_outs} ASR={run['result']['asr']} ")
    del exp, run, att
    release()
    # -- (e) n = 10,000 in S = 100 megabatches ------------------------------
    a = time.perf_counter()
    ds_e = load_dataset(C.SYNTH_MNIST, seed=0,
                        synth_train=N_HIER_E * B_HIER, synth_test=10_000)
    made_s = time.perf_counter() - a
    cfg = hier_config("Bulyan", "Bulyan", n=N_HIER_E, epochs=2, test_step=1,
                      synth_train=N_HIER_E * B_HIER)
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds_e,
                              device="cuda")
    shard_len = int(exp.shards.shape[1])
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated()
    run, per_round, errs, dev_ms = hier_drive(exp, failures,
                                              "(e) Bulyan/Bulyan n=10,000")
    add(run)
    above = run["peak_gib"] * 2 ** 30 - rest
    full = N_HIER_E * exp.flat.dim * 4
    if not (above < 1e9 and shard_len >= B_HIER):
        failures.append(f"hier (e): peak above rest {above / 1e9:.3f} GB "
                        f"(limit 1 GB), shard_len {shard_len}")
    hier_line("(e)", "Bulyan/Bulyan n=10,000", exp, run, per_round, errs,
              dev_ms, smi,
              f"synth_train={N_HIER_E * B_HIER} (made in {made_s:.1f} s) "
              f"images_per_client={shard_len} batch={B_HIER} rest_GB="
              f"{rest / 1e9:.3f} peak_above_rest_GB={above / 1e9:.3f} "
              f"(the (n, d) matrix alone: {full / 1e9:.2f} GB) ")
    del exp, run, ds_e
    release()
    print(f"[hier] phase 13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals


# -- phase 14: secure aggregation ----------------------------------------------

# The mask kernel's shapes, (n, d): small and ragged cohorts, a crossing
# of its column tile, a megabatch past 128 rows, and the main path's
# cohort (and groupwise megabatch) at mnist_mlp's width.
P14_SHAPES = ((3, 257), (19, 257), (32, 4099), (129, 4099), (N_MAIN, D_MLP))
P14_SAMPLE = 16                  # columns held against the host's threefry
P14_DROPPED = 10                 # rows dropped for the timed residue
P14_ROUNDS = ROUNDS              # (b), (c): phase 5's 21 rounds
P14_FAULT_ROUNDS, P14_RESUME_AT = 8, 4
P14_FAULTS = dict(dropout=0.1, shard_dropout=0.2, shard_dropout_dwell=2,
                  seed=4)
SECAGG_KERNELS = ("secagg_deltas", "secagg_residue", "secagg_unmask_sum")


def host_delta_columns(key_t, ids, cols):
    """The net masks at columns ``cols``, drawn on the host with
    utils/threefry.py: (n, len(cols)) uint32."""
    from attacking_federate_learning_tpu_torch.utils import threefry

    n = len(ids)
    keys = threefry.pair_keys(key_t, ids)
    a, b = np.triu_indices(n, k=1)
    c = np.broadcast_to(cols.astype(np.uint32), (len(a), len(cols)))
    y0, y1 = threefry.threefry2x32((keys[:, 0:1], keys[:, 1:2]),
                                   np.zeros_like(c), c)
    m = (y0 ^ y1).astype(np.uint64)
    ma = np.where((ids[a] < ids[b])[:, None], m, (2 ** 32 - m) % 2 ** 32)
    out = np.zeros((n, len(cols)), np.uint64)
    np.add.at(out, a, ma)
    np.add.at(out, b, (2 ** 32 - ma) % 2 ** 32)
    return (out % 2 ** 32).astype(np.uint32)


def p14_alive(kind, n, rng):
    alive = np.ones(n, bool)
    if kind == "one-dead":
        alive[n // 2] = False
    elif kind == "one-alive":
        alive[:] = False
        alive[n - 1] = True
    elif kind == "random":
        alive = rng.random(n) > 0.3
        alive[:2] = [False, True]
    elif kind == "timed":
        alive[rng.permutation(n)[:min(P14_DROPPED, n - 1)]] = False
    return alive


def check_secagg_kernels(peaks, failures, smi):
    """The mask kernel's three entry points (csrc/secagg_masks.cu) at
    P14_SHAPES, each against its plain version on the card bit for bit:
    the net masks (two launches equal too, a sample of columns equal to
    the host's threefry, every column summing to 0 mod 2**32), the
    residue and its pair count under all-true, one-dead, one-alive and
    random masks, and the unmask pass's recovered rows and flag without
    and with drops (and the flag 0 when a dead row's residue is left
    out).  Times at (100, 79,510).  Returns their kernels-line entries."""
    import torch

    from attacking_federate_learning_tpu_torch.ops import secagg_masks as K
    from attacking_federate_learning_tpu_torch.protocols import secagg as SA
    from attacking_federate_learning_tpu_torch.utils import threefry

    flops_peak, bytes_peak, _ = peaks
    int_rate = flops_peak / 4
    from attacking_federate_learning_tpu_torch.ops import _build

    for name, regs, frame, st, ld in ptxas_entries(
            _build.ptxas_log("secagg_deltas")):
        found = re.search(r"secagg_[a-z_]+?_kernel", name)
        short = found.group(0) if found else name
        print(f"[secagg kernel] ptxas {short}: {regs} registers, {frame} "
              f"bytes stack frame, {st}/{ld} bytes spill stores/loads",
              flush=True)
        if frame or st or ld:
            failures.append(f"{short}: stack frame {frame}, spills "
                            f"{st}/{ld}")
    ok_all = {name: True for name in SECAGG_KERNELS}
    for n, d in P14_SHAPES:
        rng = np.random.default_rng(n * 31 + d)
        ids = rng.permutation(100_000)[:n]
        key_t = threefry.fold_in(threefry.key(n), d)
        keys, idt = SA.round_tables(key_t, ids, "cuda")
        got = K.secagg_deltas(keys, idt, d)
        plain = K.secagg_deltas_plain(keys, idt, d)
        cols = np.unique(np.r_[0, d - 1,
                               rng.integers(0, d, P14_SAMPLE - 2)])
        host = host_delta_columns(key_t, ids, cols)
        zero = (K.from_words(got).sum(0) & 0xFFFFFFFF) == 0
        ok_d = (torch.equal(got, plain)
                and torch.equal(got, K.secagg_deltas(keys, idt, d))
                and np.array_equal(
                    got[:, torch.from_numpy(cols).cuda()].cpu().numpy()
                    .view(np.uint32), host)
                and bool(zero.all()))
        ok_r, pairs = True, {}
        for kind in ("all", "one-dead", "one-alive", "random"):
            alive = torch.from_numpy(p14_alive(kind, n, rng)).cuda()
            r, c = K.secagg_residue(keys, idt, alive, d)
            rp, cp = K.secagg_residue_plain(keys, idt, alive, d)
            na = int(alive.sum())
            pairs[kind] = int(c)
            ok_r &= (torch.equal(r, rp) and int(c) == int(cp)
                     == na * (n - na))
        G = torch.from_numpy(cohort(n, d, 0, "none", n + d)
                             * np.float32(10.0) ** rng.integers(
                                 -8, 8, (n, d)).astype(np.float32)).cuda()
        G[0, :4] = torch.tensor([float("nan"), float("inf"),
                                 -float("inf"), -0.0])
        alive = torch.from_numpy(p14_alive("random", n, rng)).cuda()
        res, _ = K.secagg_residue(keys, idt, alive, d)
        ok_u, flags = True, []
        for r, al, want in ((None, None, 1), (res, alive, 1),
                            (None, alive, 0)):
            rec, ok = K.secagg_unmask_sum(G, got, r, al)
            recp, okp = K.secagg_unmask_sum_plain(G, got, r, al)
            clear = G if al is None else torch.where(al[:, None], G, 0.0)
            flags.append(int(ok))
            ok_u &= (torch.equal(rec.view(torch.int32),
                                 recp.view(torch.int32))
                     and torch.equal(rec.view(torch.int32),
                                     clear.view(torch.int32))
                     and int(ok) == int(okp) == want)
        ok_all["secagg_deltas"] &= ok_d
        ok_all["secagg_residue"] &= ok_r
        ok_all["secagg_unmask_sum"] &= ok_u
        print(f"[secagg kernel] ({n}, {d}) deltas bit_equal_plain_and_"
              f"host_columns={ok_d} residue bit_equal_plain={ok_r} "
              f"pairs={pairs} unmask bit_equal_plain={ok_u} flags="
              f"{flags} (want [1, 1, 0])", flush=True)
    # Times at the main path's shape, its plan's grid beside.
    n, d = N_MAIN, D_MLP
    rng = np.random.default_rng(7)
    ids = rng.permutation(100_000)[:n]
    keys, idt = SA.round_tables(threefry.fold_in(threefry.key(5), 1), ids,
                                "cuda")
    deltas = K.secagg_deltas(keys, idt, d)
    alive = torch.from_numpy(p14_alive("timed", n, rng)).cuda()
    res, _ = K.secagg_residue(keys, idt, alive, d)
    G = torch.from_numpy(cohort(n, d, F_MAIN, "alie", 14)).cuda()
    na = int(alive.sum())
    # The work of each (ops/secagg_masks.py: OPS_PER_WORD integer
    # operations a drawn word, at a quarter of the fp32 rate).
    work = {
        "secagg_deltas": (K.secagg_deltas_cost(n, d),
                          lambda: K.secagg_deltas(keys, idt, d),
                          lambda: K.secagg_deltas_plain(keys, idt, d), 2,
                          "protocols/secagg.py:94 (pairwise_deltas)"),
        "secagg_residue": (K.secagg_residue_cost(n, d, na),
                           lambda: K.secagg_residue(keys, idt, alive, d),
                           lambda: K.secagg_residue_plain(keys, idt, alive,
                                                          d), 3,
                           "protocols/secagg.py:148 (recovery_residue)"),
        "secagg_unmask_sum": (K.secagg_unmask_sum_cost(n, d, True, True),
                              lambda: K.secagg_unmask_sum(G, deltas, res,
                                                          alive),
                              lambda: K.secagg_unmask_sum_plain(
                                  G, deltas, res, alive), 5,
                              "protocols/secagg.py:174 (unmask_sum)"),
    }
    plan = K.deltas_plan(n, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    entries = {}
    for name, (cost, fn, plain, reps, where) in work.items():
        ops, nbytes = cost.flops, cost.bytes
        ms = time_ms(fn, 20)
        pms = time_ms(plain, reps)
        t_b, t_o = nbytes / bytes_peak * 1e3, ops / int_rate * 1e3
        b_ms, b_by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        print(f"[secagg kernel] {name:17s} ({n}, {d}) ms={ms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={b_ms:.4f} ({b_by}; "
              f"{ops / 1e9:.2f} G int32 operations at "
              f"{int_rate / 1e12:.2f} T/s, {nbytes / 1e6:.1f} MB) "
              f"library_ms=none plan={tuple(plan)} dropped={n - na} "
              f"on {smi}", flush=True)
        if not ok_all[name]:
            failures.append(f"{name}: not bit-equal to its plain version "
                            f"(or the host's bits)")
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/secagg_masks.cu",
            "replaces": f"attacking_federate_learning_tpu/{where}, XLA "
                        f"threefry and sums: no TPU kernel",
            "launches": 0,
            "max_abs_err": 0.0 if ok_all[name] else float("inf"),
            "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": [n, d]}
    del deltas, res, G
    return entries


def timed_protect(store):
    """Patch protocols/secagg.py's protect (the protocol round: draw,
    residue, unmask) with CUDA events around each call; returns the
    restore function."""
    import torch

    from attacking_federate_learning_tpu_torch.protocols import secagg as SA

    inner = SA.protect

    def protect(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args, **kw)
        b.record()
        store.append((a, b))
        return out

    SA.protect = protect

    def restore():
        SA.protect = inner

    return restore


def byte_equal(x, y):
    import torch

    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def run_secagg_path(ds, failures, smi):
    """Phase 14: secure aggregation through run() at mnist_mlp's width:
    the mask kernel against its plain version; (b) vanilla ALIE NoDefense
    at n = 100, f = 24, 21 rounds, and (c) with dropout 0.1, each
    byte-equal to its clear twin; (d) groupwise at n = 1,000, S = 10
    under tier-2 NoDefense, Krum and Median, byte-equal to the clear
    hierarchical twins; (e) groupwise with dropout and shard-domain
    dropout, byte-equal to its clear twin, preempted after round 4 and
    resumed bit for bit.  Launches checked exactly: one deltas draw and
    one unmask a cohort or megabatch, a residue only where a row
    dropped.  Returns launches per kernel summed over the runs."""
    import tempfile

    import torch

    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import FaultConfig
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.core.faults import (
        hier_round_faults
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.checkpoint import (
        Checkpointer
    )

    t_phase = time.perf_counter()
    totals = {name: 0 for name in _build.LAUNCHES}

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def pair(cfg_clear, cfg_masked, kernels, label, allowed=()):
        """The clear twin's run and the masked one's, drive() each (the
        ``kernels`` must launch, those and ``allowed`` may); the masked
        run with the protect stage timed."""
        runs = []
        for cfg, secure in ((cfg_clear, False), (cfg_masked, True)):
            exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                      device="cuda")
            must = kernels + (("secagg_deltas", "secagg_unmask_sum")
                              if secure else ())
            may = must + allowed + (("secagg_residue",) if secure
                                    and exp.faults is not None else ())
            banned = tuple(k for k in _build.LAUNCHES if k not in may)
            events = []
            restore = timed_protect(events)
            kind = "masked" if secure else "clear"
            try:
                run = drive(exp, must, banned, failures,
                            f"secagg {label} {kind}")
            finally:
                restore()
            torch.cuda.synchronize()
            run["protect_ms"] = [a.elapsed_time(b) for a, b in events]
            run["exp"] = exp
            for k, v in run["launches"].items():
                totals[k] += v
            runs.append(run)
        clear, masked = runs
        same = (byte_equal(masked["exp"].state.weights,
                           clear["exp"].state.weights)
                and byte_equal(masked["exp"].state.velocity,
                               clear["exp"].state.velocity))
        return clear, masked, same

    def line(tag, label, clear, masked, same, ok, extra=""):
        exp = masked["exp"]
        per = masked["protect_ms"]
        rounds = exp.cfg.epochs
        calls = len(per) // rounds
        print(f"[secagg] {tag} {label:22s} n={exp.n} f={exp.f} "
              f"acc={masked['acc_txt']} % median_round_ms="
              f"{masked['median_ms']:.3f} clear_twin_round_ms="
              f"{clear['median_ms']:.3f} protect_ms="
              f"{statistics.median(per):.3f} a call ({calls} a round) "
              f"deliver_ms={masked['deliver_ms']:.3f} peak_GiB="
              f"{masked['peak_gib']:.3f}"
              f" byte_equal_clear={same} launches={masked['launches']} "
              f"checks_ok={ok} {extra}on {smi}", flush=True)

    entries = check_secagg_kernels(peaks_for(
        torch.cuda.get_device_name(0))[1], failures, smi)
    n = N_MAIN
    # -- (b) vanilla, clean ---------------------------------------------------
    clear, masked, same = pair(main_config("NoDefense", 0.24),
                               main_config("NoDefense", 0.24,
                                           secagg="vanilla"),
                               (), "(b) vanilla")
    rows = masked["result"]["secagg"]
    got = {k: masked["launches"][k] for k in SECAGG_KERNELS}
    ok = (same and got == {"secagg_deltas": P14_ROUNDS,
                           "secagg_residue": 0,
                           "secagg_unmask_sum": P14_ROUNDS}
          and [r["round"] for r in rows] == list(range(P14_ROUNDS))
          and all(r["sum_check_ok"] == 1 and r["dropped"] == 0 for r in rows))
    if not ok:
        failures.append(f"secagg (b): byte_equal={same} launches={got} "
                        f"events={rows[:3]}")
    line("(b)", "vanilla ALIE NoDefense", clear, masked, same, ok)
    del clear, masked
    release()
    # -- (c) vanilla with dropout ------------------------------------------
    fc = FaultConfig(dropout=0.1)
    clear, masked, same = pair(main_config("NoDefense", 0.24, fc),
                               main_config("NoDefense", 0.24, fc,
                                           secagg="vanilla"),
                               (), "(c) vanilla dropout")
    rows, frows = masked["result"]["secagg"], masked["result"]["faults"]
    drops = [f["injected_dropout"] for f in frows]
    got = {k: masked["launches"][k] for k in SECAGG_KERNELS}
    want = {"secagg_deltas": P14_ROUNDS, "secagg_residue": P14_ROUNDS,
            "secagg_unmask_sum": P14_ROUNDS}
    events_ok = rows == [
        {"round": t, "sum_check_ok": 1, "dropped": k,
         "masks_reconstructed": (n - k) * k, "recovery": int(k > 0)}
        for t, k in enumerate(drops)]
    ok = same and got == want and events_ok and masked["counts_ok"]
    if not ok:
        failures.append(f"secagg (c): byte_equal={same} launches={got} "
                        f"(want {want}) events_ok={events_ok} "
                        f"fault_counts_ok={masked['counts_ok']}")
    line("(c)", "vanilla dropout 0.1", clear, masked, same, ok,
         f"drops={drops} events_equal_replay={events_ok} ")
    del clear, masked
    release()
    # -- (d) groupwise ------------------------------------------------------
    for t2 in ("NoDefense", "Krum", "Median"):
        clear, masked, same = pair(
            hier_config("NoDefense", t2),
            hier_config("NoDefense", t2, secagg="groupwise"),
            tuple(HIER_UNMASKED[t2]), f"(d) groupwise {t2}")
        exp = masked["exp"]
        S, rounds = exp._placement.num_shards, exp.cfg.epochs
        rows = masked["result"]["secagg"]
        got = {k: masked["launches"][k] for k in SECAGG_KERNELS}
        want = {"secagg_deltas": S * rounds, "secagg_residue": 0,
                "secagg_unmask_sum": S * rounds}
        tier2 = {k: masked["launches"][k] for k in HIER_UNMASKED[t2]}
        ok = (same and got == want
              and tier2 == {k: v * rounds
                            for k, v in HIER_UNMASKED[t2].items()}
              and all(r["sum_check_ok"] == 1 and r["groups"] == S
                      and len(r["group_sum_norms"]) == S
                      and all(math.isfinite(x) and x > 0
                              for x in r["group_sum_norms"])
                      for r in rows))
        if not ok:
            failures.append(f"secagg (d) {t2}: byte_equal={same} launches="
                            f"{got} (want {want}) tier 2 {tier2}")
        norms = [round(x, 3) for x in rows[0]["group_sum_norms"][:3]]
        line("(d)", f"groupwise NoDefense/{t2}", clear, masked, same, ok,
             f"S={S} group_sum_norms_r0[:3]={norms} ")
        del clear, masked, exp
        release()
    # -- (e) groupwise, faulted, preempted and resumed ------------------------
    fc = FaultConfig(**P14_FAULTS)
    kw = dict(epochs=P14_FAULT_ROUNDS, test_step=4, faults=fc)
    clear, masked, same = pair(
        hier_config("NoDefense", "Krum", **kw),
        hier_config("NoDefense", "Krum", secagg="groupwise", **kw),
        (), "(e) groupwise faulted",
        allowed=("pairwise_distances", "masked_median"))
    exp = masked["exp"]
    place, m = exp._placement, exp._placement.megabatch
    drops = [hier_round_faults(exp._fault_key, t, place, fc)[0][:, 0]
             .sum(1) for t in range(P14_FAULT_ROUNDS)]
    rows = masked["result"]["secagg"]
    got = {k: masked["launches"][k] for k in SECAGG_KERNELS}
    S = place.num_shards
    want = {k: S * P14_FAULT_ROUNDS for k in SECAGG_KERNELS}
    events_ok = all(
        r["dropped"] == int(k.sum())
        and r["masks_reconstructed"] == int(((m - k) * k).sum())
        and r["recovery"] == int(k.sum() > 0) and r["sum_check_ok"] == 1
        for r, k in zip(rows, drops))
    cfg = hier_config("NoDefense", "Krum", secagg="groupwise", **kw)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p14_") as root:
        first = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                    device="cuda")
        for t in range(P14_RESUME_AT):
            first.run_round(t)
        ck = Checkpointer(cfg, run_dir=root)
        path = ck.save_auto(first.state, extra=first.carry_state_host())
        del first
        second = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                                     device="cuda")
        second.state, extra = ck.resume(path, with_extra=True,
                                        device="cuda")
        second.restore_carry_state(extra)
        resumed_rows = []
        for t in range(P14_RESUME_AT, cfg.epochs):
            second.run_round(t)
            (_, _, rec), = second._host_records(
                [(None, None, second.last_round_secagg)])
            resumed_rows.append(rec)
        resumed_ok = (byte_equal(second.state.weights, exp.state.weights)
                      and byte_equal(second.state.velocity,
                                     exp.state.velocity)
                      and resumed_rows == rows[P14_RESUME_AT:]
                      and not extra)
        del second
    ok = same and got == want and events_ok and resumed_ok and masked[
        "counts_ok"]
    if not ok:
        failures.append(f"secagg (e): byte_equal={same} launches={got} "
                        f"(want {want}) events_ok={events_ok} resumed "
                        f"bit for bit {resumed_ok} fault events = replay "
                        f"{masked['counts_ok']}")
    line("(e)", "groupwise faulted", clear, masked, same, ok,
         f"drops_per_round={[int(k.sum()) for k in drops]} "
         f"residues={want['secagg_residue']} actions="
         f"{masked.get('actions')} events_ok={events_ok} resumed_at="
         f"{P14_RESUME_AT} resume_bit_equal={resumed_ok} ")
    del clear, masked, exp
    release()
    print(f"[secagg] phase 14 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries, totals


# --- phase 15: the observatories --------------------------------------------
# The four flags of phase 15 (a) and (c); (d) without the round stats.
P15_FLAGS = dict(telemetry=True, margins=True, numerics=True,
                 log_round_stats=True)
P15_CHECKED = 3        # rounds whose diagnostics are held against the CPU
# (a): (defense, mal_prop, faulted, must launch, anchor launches a round
# the margins add: the trimmed mean's median, the kernel's own over the
# masked rows, and Bulyan's trim stage's).
P15_FLAT = (
    ("Krum", 0.24, False, ("krum_scores",), {}),
    ("TrimmedMean", 0.24, False, ("trimmed_mean",), {"median": 1}),
    ("Bulyan", 0.24, False, ("pairwise_distances", "trimmed_mean"),
     {"median": 1}),
    ("Median", 0.24, False, ("median",), {}),
    ("Krum", 0.1, True, ("pairwise_distances",), {}),
    ("TrimmedMean", 0.1, True, ("masked_trimmed_mean",),
     {"masked_median": 1}),
)
# (b): the science gate's margin pair (tools/science_gate.py: CELLS and
# measure_cell's constants), bands from BEHAVIOR_BASELINE.json.
P15_SCIENCE = (("bulyan_margin_collapse", {}),
               ("bulyan_margin_rescue",
                dict(partition="femnist_style", style_strength=0.5)))
P15_DISCRIMINATORS = ("margin_tie_rounds", "colluder_selected_total")
# (c): phase 10 (a)'s Krum 'poly' and TrimmedMean 'poly' (f = 24, k = 64).
P15_ASYNC = (("Krum", ("pairwise_distances",), {}),
             ("TrimmedMean", ("masked_trimmed_mean",),
              {"masked_median": 1}))
# Diagnostics held bit for bit against the CPU twin's: selections, picks,
# rank memberships, counts.
EXACT_DIAGNOSTICS = ("selection_mask", "num_tie_rows", "kept_fraction",
                     "trim_fraction", "margin_kept_frac", "margin_trim_kept")


def diagnostics_vs_cpu(got, want, G):
    """A defense's diagnostics on the card (``got``) against its CPU
    twin's on the same matrix ``G`` (``want``): the same keys; selections,
    picks, rank memberships and counts bit for bit
    (EXACT_DIAGNOSTICS); Krum scores within the kernel-vs-plain band of
    phase 3's check_krum, per row 2 e_i + 2 n eps rowsum_i with e_i =
    sum_j sqrt(b_ij) of the d^2 band b of the Gram's chains (an upper
    bound of its min(sqrt b, b / D)); a selection margin, gap or slack,
    the difference of two scores, within twice the largest row band; the
    cancellation bits within that band's relative share of the winning
    score, over ln 2, plus 1e-6; the mean-type fields (distances to the
    aggregate, boundary distances: sums of d terms) within 4 sqrt(d) eps
    of their largest magnitude.  Non-finite entries must sit at the same
    places with the same values.  Returns (worst banded error, ok, the
    fields out of bounds with their count of differing entries)."""
    import torch

    eps = float(np.finfo(np.float32).eps)
    n, d = G.shape
    G64 = G.double()
    sq = (G64 * G64).sum(1)
    D64 = (sq[:, None] + sq[None, :] - 2.0 * (G64 @ G64.T)).clamp(
        min=0.0).sqrt()
    b = d2_band(sq, kernel_chain(d)) + d2_band(sq, d)
    row = (2.0 * b.sqrt().sum(1) + 2.0 * n * eps * D64.sum(1)).cpu()
    pair = 2.0 * float(row.max())
    bad = {k: -1 for k in set(got) ^ set(want)}
    worst = 0.0
    for k in set(got) & set(want):
        g, w = got[k].detach().cpu(), want[k]
        if k in EXACT_DIAGNOSTICS:
            same = ((g == w) | (torch.isnan(g.double())
                                & torch.isnan(w.double())))
            if g.dtype != w.dtype or g.shape != w.shape:
                bad[k] = -1
            elif not bool(same.all()):
                bad[k] = int((~same).sum())
            continue
        g, w = g.double(), w.double()
        fin = torch.isfinite(g) & torch.isfinite(w)
        if not bool(((g == w) | fin).all()):
            bad[k] = int((~((g == w) | fin)).sum())
            continue
        if k == "scores":
            band = row
        elif k in ("margin_selection", "margin_gap", "margin_slack"):
            band = torch.full_like(g, pair)
        elif k == "num_cancel_bits":
            win = float(torch.where(fin, w, math.inf).min())
            band = torch.full_like(g, pair / max(win, 1e-30) / math.log(2)
                                   + 1e-6)
        else:
            scale = float(torch.where(fin, w.abs(), 0.0).max())
            band = torch.full_like(g, 4.0 * math.sqrt(d) * eps * scale)
        err = torch.where(fin, (g - w).abs(), 0.0)
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        if not bool((err <= band).all()):
            bad[k] = int((err > band).sum())
    return worst, not bad, bad


def observed_run(exp, kernels, failures, label, check=False, timer=None):
    """One phase-15 run through ``drive`` (events kept and validated),
    each round's device time from CUDA events; with ``check`` the first
    P15_CHECKED defense calls held against the CPU by
    ``checked_defense``, diagnostics included.  Returns drive's result
    with the engine, the rounds' device ms (rounds past the checked
    ones) and the checks' records."""
    import torch

    from attacking_federate_learning_tpu_torch.utils.metrics import (
        validate_event
    )

    excluded, errs, dist_errs, diag_errs = [], [], [], []
    if check:
        checked_defense(exp, P15_CHECKED, excluded, errs, dist_errs,
                        diag_errs=diag_errs)
    events, inner = [], exp.run_round

    def timed(t):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(t)
        ev[1].record()
        events.append(ev)
        return out

    exp.run_round = timed
    run = drive(exp, kernels, (), failures, f"observe {label}", excluded,
                keep_events=True, timer=timer)
    torch.cuda.synchronize()
    dev = [a.elapsed_time(b) for a, b in events]
    run.update(exp=exp, dev_ms=statistics.median(dev[P15_CHECKED:] or dev),
               checks=errs + dist_errs, diag_checks=diag_errs)
    for e in run["events"]:
        validate_event(e)
    return run


def same_state(a, b):
    return (byte_equal(a.state.weights, b.state.weights)
            and byte_equal(a.state.velocity, b.state.velocity))


def kinds_of(events):
    out = {}
    for e in events:
        out[e["kind"]] = out.get(e["kind"], 0) + 1
    return out


def run_observe_path(ds, failures, smi):
    """Phase 15: the observatories (telemetry, margins, numerics, round
    stats) through run() on the card, each run beside its flags-off twin
    run in the phase: weights and velocity byte-equal, launches the
    twin's plus the margins' documented anchor launches, every event
    valid.  (a) phase 5's cells; (b) the science gate's Bulyan margin
    pair in BEHAVIOR_BASELINE.json's bands; (c) phase 10's async Krum and
    TrimmedMean; (d) phase 13's n = 1,000 Krum/Krum and Median/Median and
    groupwise secagg.  Returns launches per kernel summed over the
    runs."""
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    totals = {name: 0 for name in _build.LAUNCHES}

    def pair(cfg_on, cfg_off, kernels, label, anchors, dataset=ds,
             check=False):
        """The flags-off twin, then the run with the flags; returns both
        runs, byte-equality of their states and whether the launches are
        the twin's plus ``anchors`` a round."""
        runs = []
        for cfg in (cfg_off, cfg_on):
            exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std),
                                      dataset, device="cuda")
            on = cfg is cfg_on
            must = kernels + (tuple(anchors) if on else ())
            runs.append(observed_run(exp, must, failures,
                                     label + (" on" if on else " off"),
                                     check=check and on))
            for k, v in runs[-1]["launches"].items():
                totals[k] += v
        off, on = runs
        want = dict(off["launches"])
        for k, v in anchors.items():
            want[k] += v * cfg_on.epochs
        same = same_state(on["exp"], off["exp"])
        launches_ok = on["launches"] == want
        if not (same and launches_ok):
            failures.append(f"observe {label}: byte_equal_off_twin={same} "
                            f"launches {on['launches']} (want {want})")
        return off, on, same, launches_ok

    def line(tag, label, off, on, same, ok, extra=""):
        exp = on["exp"]
        print(f"[observe] {tag} {label:26s} n={exp.n} f={exp.f} "
              f"acc={on['acc_txt']} % round_ms={on['median_ms']:.3f} "
              f"off_twin_round_ms={off['median_ms']:.3f} (host clock) "
              f"device_round_ms={on['dev_ms']:.3f} off_twin="
              f"{off['dev_ms']:.3f} extra_device_ms="
              f"{on['dev_ms'] - off['dev_ms']:.3f} (CUDA events) "
              f"byte_equal_off_twin={same} kinds={kinds_of(on['events'])} "
              f"checks_ok={ok} {extra}on {smi}", flush=True)

    # -- (a) the flat rounds, phase 5's cells --------------------------------
    for defense, mal_prop, faulted, kernels, anchors in P15_FLAT:
        fc = FaultConfig(**FAULTS_MAIN) if faulted else None
        label = f"(a) {defense} {'faulted' if faulted else 'clean'}"
        off, on, same, launches_ok = pair(
            main_config(defense, mal_prop, fc, **P15_FLAGS),
            main_config(defense, mal_prop, fc), kernels, label, anchors,
            check=True)
        exp, evs = on["exp"], on["events"]
        rounds = exp.cfg.epochs
        per_kind = kinds_of(evs)
        kinds_ok = all(per_kind.get(k) == rounds for k in
                       ("round", "defense", "attack", "margin", "numerics"))
        # The tie-lock: identical crafted rows score bit-equal (the
        # fused kernel and the masked sort route alike); clean runs,
        # where every colluder row is the crafted one.
        tie_ok = True
        if defense in ("Krum", "Bulyan") and not faulted:
            tie_ok = all(len(set(e["scores"][:exp.m_mal])) == 1
                         for e in evs if e["kind"] == "defense")
        cpu_ok = (len(on["diag_checks"]) == P15_CHECKED
                  and all(c[1] for c in on["diag_checks"] + on["checks"]))
        ok = same and launches_ok and kinds_ok and tie_ok and cpu_ok
        if not ok:
            failures.append(f"observe {label}: kinds {per_kind} tie_lock="
                            f"{tie_ok} vs CPU {on['diag_checks']} "
                            f"{on['checks']}")
        sel = [e.get("krum_selected") for e in evs if e["kind"] == "round"]
        line("(a)", label, off, on, same, ok,
             f"launches_ok={launches_ok} tie_lock={tie_ok} diag_vs_cpu="
             f"{[(float(f'{e:.3e}'), o, b) for e, o, b in on['diag_checks']]} "
             + (f"krum_selected={sel} " if defense == "Krum" else ""))
        del off, on, exp
    # -- (b) the science gate's margin pair -----------------------------------
    with open(os.path.join(ROOT, "BEHAVIOR_BASELINE.json")) as fh:
        baseline = json.load(fh)["cells"]
    hard = load_dataset(C.SYNTH_MNIST_HARD, seed=0, synth_train=4000,
                        synth_test=1000)
    for cell, extra in P15_SCIENCE:
        cfg = ExperimentConfig(
            dataset=C.SYNTH_MNIST_HARD, users_count=19, mal_prop=0.2,
            batch_size=64, epochs=30, test_step=15, seed=0,
            synth_train=4000, synth_test=1000, defense="Bulyan",
            num_std=1.5, margins=True, **extra)
        exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), hard,
                                  device="cuda")
        run = observed_run(exp, ("pairwise_distances", "trimmed_mean",
                                 "median"), failures, f"(b) {cell}")
        for k, v in run["launches"].items():
            totals[k] += v
        cms = [e.get("colluder_margin") for e in run["events"]
               if e["kind"] == "margin"]
        got = {"margin_tie_rounds": sum(1 for v in cms if v == 0.0),
               "colluder_selected_total": sum(
                   e.get("colluder_selected", 0) for e in run["events"]
                   if e["kind"] == "margin"),
               "final_accuracy": run["result"]["accuracies"][-1]}
        bands = {k: baseline[cell][k] for k in P15_DISCRIMINATORS}
        ok = len(cms) == cfg.epochs and all(
            abs(got[k] - b["value"]) <= b["band"] for k, b in bands.items())
        if not ok:
            failures.append(f"observe (b) {cell}: {got} against {bands}")
        print(f"[observe] (b) {cell:26s} n=19 f={exp.f} {got} baseline "
              f"{ {k: (b['value'], b['band']) for k, b in bands.items()} } "
              f"(final accuracy baseline "
              f"{baseline[cell]['final_accuracy']['value']}) round_ms="
              f"{run['median_ms']:.3f} device_round_ms="
              f"{run['dev_ms']:.3f} in_bands={ok} on {smi}", flush=True)
        del exp, run
    del hard
    # -- (c) async rounds, phase 10 (a)'s cells -------------------------------
    for defense, kernels, anchors in P15_ASYNC:
        off, on, same, launches_ok = pair(
            async_config(defense, 0.24, 64, "poly", False, **P15_FLAGS),
            async_config(defense, 0.24, 64, "poly", False), kernels,
            f"(c) async {defense} poly", anchors)
        per_kind = kinds_of(on["events"])
        ok = (same and launches_ok and all(
            per_kind.get(k) == on["exp"].cfg.epochs
            for k in ("async", "round", "defense", "margin", "numerics")))
        if not ok:
            failures.append(f"observe (c) {defense}: kinds {per_kind}")
        line("(c)", f"async {defense} poly", off, on, same, ok)
        del off, on
    gc.collect()
    torch.cuda.empty_cache()
    # -- (d) hierarchical rounds and groupwise secagg --------------------------
    flags3 = {k: True for k in ("telemetry", "margins", "numerics")}
    for tier1, tier2 in (("Krum", "Krum"), ("Median", "Median")):
        off, on, same, launches_ok = pair(
            hier_config(tier1, tier2, **flags3), hier_config(tier1, tier2),
            tuple(HIER_UNMASKED[tier1]), f"(d) hier {tier1}/{tier2}", {})
        exp = on["exp"]
        S, m = exp._placement.num_shards, exp._placement.megabatch
        sel = [e for e in on["events"] if e["kind"] == "shard_selection"]
        ok = (same and launches_ok and len(sel) == exp.cfg.epochs
              and all(np.shape(e["shard_grad_norms"]) == (S, m)
                      and len(e["tier2_est_norms"]) == S for e in sel))
        if not ok:
            failures.append(f"observe (d) {tier1}/{tier2}: "
                            f"{len(sel)} shard_selection events")
        line("(d)", f"hier {tier1}/{tier2}", off, on, same, ok,
             f"S={S} shard_selection_keys="
             f"{sorted(k for k in sel[0] if k.startswith('shard_'))} ")
        del off, on, exp
        gc.collect()
        torch.cuda.empty_cache()
    off, on, same, launches_ok = pair(
        hier_config("NoDefense", "Krum", secagg="groupwise",
                    telemetry=True),
        hier_config("NoDefense", "Krum", secagg="groupwise"),
        ("krum_scores", "secagg_deltas", "secagg_unmask_sum"),
        "(d) groupwise NoDefense/Krum", {})
    S = on["exp"]._placement.num_shards
    rows_on, rows_off = on["result"]["secagg"], off["result"]["secagg"]
    norms_equal = [r["group_sum_norms"] for r in rows_on] == [
        r["group_sum_norms"] for r in rows_off]
    ok = (same and launches_ok and norms_equal
          and all(len(r.get("group_cos_to_mean", ())) == S
                  for r in rows_on))
    if not ok:
        failures.append(f"observe (d) groupwise: group_sum_norms equal "
                        f"{norms_equal}, cos {rows_on[0].keys()}")
    line("(d)", "groupwise NoDefense/Krum", off, on, same, ok,
         f"group_sum_norms_bit_equal={norms_equal} group_cos_to_mean_r0="
         f"{[round(x, 4) for x in rows_on[0]['group_cos_to_mean'][:3]]} ")
    del off, on
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[observe] phase 15 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals


# -- phase 16: the walls and the cost ledger ------------------------------------

# (a): phase 5's clean ALIE cells at f = 24: (defense, must launch).
P16_FLAT = (("NoDefense", ()), ("Krum", ("krum_scores",)),
            ("TrimmedMean", ("trimmed_mean",)),
            ("Bulyan", ("pairwise_distances", "trimmed_mean")),
            ("Median", ("median",)))
# (b): masked rounds: (label, config, must launch).  Kernel 5 w is the
# async TrimmedMean's weighted masked trimmed mean.
P16_MASKED = (
    ("(b) Krum faulted", ("main", "Krum"), ("pairwise_distances",)),
    ("(b) TrimmedMean faulted", ("main", "TrimmedMean"),
     ("masked_trimmed_mean",)),
    ("(b) Median faulted", ("main", "Median"), ("masked_median",)),
    ("(b) async Krum poly", ("async", "Krum"), ("pairwise_distances",)),
    ("(b) async TrimmedMean poly", ("async", "TrimmedMean"),
     ("masked_trimmed_mean",)))
P16_UNATTRIBUTED = 0.05     # the flat rounds' largest unattributed share
P16_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def walls_of(exp, kernels, failures, label):
    """Checks every capture booked in ``exp``'s run (exp.wall_records):
    the partition exact (stage sums + unattributed == total, the booked
    events the trace's device events, their time within float rounding
    of the trace's), and the device time of each kernel of ``kernels``
    ({name: stages allowed}, each named in the trace by the range around
    its launch, its C entry point) in those stages only.  Returns the device
    us a stage summed over the captures, the unattributed us, the
    captured rounds, the launches joined without their launch event and
    each kernel's stages."""
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.costs import STAGES
    from attacking_federate_learning_tpu_torch.utils.walls import (
        find_trace_file, load_trace_events
    )

    stage_us = {s: 0.0 for s in STAGES}
    out = {"stage_us": stage_us, "unattributed_us": 0.0, "rounds": 0,
           "unknown": 0, "kernels": {}, "captures": len(exp.wall_records),
           "exact": True}
    for rec in exp.wall_records:
        rec.check()
        dev = [e for e in load_trace_events(find_trace_file(rec.trace_dir))
               if e.get("cat") in P16_DEVICE_CATS]
        total = math.fsum(float(e.get("dur", 0.0)) for e in dev)
        exact = (rec.coverage["op_events"] == len(dev)
                 and rec.total_us == sum(rec.stages.values())
                 + rec.unattributed_us
                 and abs(rec.total_us - total) <= 1e-9 * max(total, 1.0))
        out["exact"] &= exact
        for st, us in rec.stages.items():
            stage_us[st] += us
        out["unattributed_us"] += rec.unattributed_us
        out["rounds"] += rec.rounds
        out["unknown"] += rec.coverage["unknown_events"]
        for name in kernels:
            cells = rec.ops.get(_build.KERNELS[name][1], {})
            got = out["kernels"].setdefault(name, {})
            for st, (count, us) in cells.items():
                got[st] = got.get(st, 0.0) + us
    ok = out["exact"] and out["captures"] > 0
    for name, allowed in kernels.items():
        got = out["kernels"].get(name, {})
        if not got or set(got) - set(allowed):
            ok = False
    if not ok:
        failures.append(f"walls {label}: exact={out['exact']} captures="
                        f"{out['captures']} kernels {out['kernels']} "
                        f"(allowed {kernels})")
    out["ok"] = ok
    return out


def stage_text(w):
    """Per stage: device ms a round and its share of the captures'
    device time; the unattributed share last."""
    total = sum(w["stage_us"].values()) + w["unattributed_us"]
    rounds = max(w["rounds"], 1)
    parts = [f"{st}={us / rounds / 1e3:.4f}ms/{us / total:.3f}"
             for st, us in w["stage_us"].items() if us > 0]
    share = w["unattributed_us"] / total if total else 0.0
    ua = w["unattributed_us"] / rounds / 1e3
    return " ".join(parts) + f" unattributed={ua:.4f}ms/{share:.4f}", share


def run_walls_path(ds, failures, smi):
    """Phase 16: the measured walls and the cost ledger on the card, each
    run beside its flags-off twin run in the phase (weights and velocity
    byte-equal, the same launches).  (a) phase 5's clean cells with
    profile_every = 1: every capture's partition exact, the kernels in
    tier1_aggregate, deliver and apply filled, the unattributed device
    share at most P16_UNATTRIBUTED; (b) faulted Krum, TrimmedMean and
    Median and async Krum and TrimmedMean 'poly': quarantine filled,
    kernels 1, 5, 6 and 5 w in tier1_aggregate; (c) phase 13's n =
    1,000, S = 10 Krum/Krum (both aggregate stages), groupwise secagg (S
    in protect) and DnC (T in tier1_aggregate); (d) the cost report on
    phase 5's Krum, profile_every = 1: one 'cost' and one 'stage_cost'
    event an entry point, each kernel's count its table bound's formula,
    the peak from the allocator, the captures beside the counted stage
    shares (measured_vs_modeled); (e) Krum with profile_every = 2: the
    round ms of the uncaptured interval beside the twin's, the captured
    ones apart.
    Returns launches per kernel summed over the runs."""
    import shutil
    import tempfile

    import torch

    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import FaultConfig
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.metrics import (
        RunLogger, validate_event
    )

    t_phase = time.perf_counter()
    totals = {name: 0 for name in _build.LAUNCHES}
    tmp = tempfile.mkdtemp(prefix="walls_")
    tier1 = ("tier1_aggregate",)

    def pair(cfg_on, cfg_off, kernels, label, dataset=ds, before=None,
             timer=None):
        """The flags-off twin, then the run with the flags (``before``
        called on its engine first, ``timer`` given to its run()); returns
        both runs and whether the states are byte-equal and the launches
        the twin's."""
        runs = []
        for cfg in (cfg_off, cfg_on):
            exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std),
                                      dataset, device="cuda")
            on = cfg is cfg_on
            if on and before is not None:
                before(exp)
            runs.append(observed_run(exp, kernels, failures,
                                     f"walls {label}"
                                     + (" on" if on else " off"),
                                     timer=timer if on else None))
            for k, v in runs[-1]["launches"].items():
                totals[k] += v
        off, on = runs
        same = same_state(on["exp"], off["exp"])
        launches_ok = on["launches"] == off["launches"]
        if not (same and launches_ok):
            failures.append(f"walls {label}: byte_equal_off_twin={same} "
                            f"launches {on['launches']} (twin "
                            f"{off['launches']})")
        return off, on, same and launches_ok

    def line(tag, label, off, on, ok, w, extra=""):
        text, share = stage_text(w)
        print(f"[walls] {tag} {label:28s} round_ms={on['median_ms']:.3f} "
              f"off_twin_round_ms={off['median_ms']:.3f} (host clock) "
              f"captures={w['captures']} rounds={w['rounds']} device a "
              f"round by stage (ms/share): {text} exact={w['exact']} "
              f"unjoined_launches={w['unknown']} kernels="
              f"{ {k: sorted(v) for k, v in w['kernels'].items()} } "
              f"twin_ok={ok} {extra}on {smi}", flush=True)
        return share

    def walls_cfg(cfg, every=1):
        import dataclasses
        return dataclasses.replace(cfg, profile_every=every, log_dir=tmp)

    # -- (a) the flat rounds --------------------------------------------------
    for defense, kernels in P16_FLAT:
        cfg = main_config(defense, 0.24)
        off, on, ok = pair(walls_cfg(cfg), cfg, kernels,
                           f"(a) {defense}")
        w = walls_of(on["exp"], {k: tier1 for k in kernels}, failures,
                     f"(a) {defense}")
        share = line("(a)", defense, off, on, ok, w)
        filled = (w["stage_us"]["deliver"] > 0 and w["stage_us"]["apply"] > 0
                  and (not kernels or w["stage_us"]["tier1_aggregate"] > 0))
        if share > P16_UNATTRIBUTED or not filled:
            failures.append(f"walls (a) {defense}: unattributed share "
                            f"{share:.4f} (at most {P16_UNATTRIBUTED}), "
                            f"stages {w['stage_us']}")
        del off, on
    # -- (b) masked rounds ----------------------------------------------------
    faults = FaultConfig(**FAULTS_MAIN)
    for label, (kind, defense), kernels in P16_MASKED:
        cfg = (main_config(defense, 0.1, faults) if kind == "main"
               else async_config(defense, 0.24, 64, "poly", False))
        off, on, ok = pair(walls_cfg(cfg), cfg, kernels, label)
        w = walls_of(on["exp"], {k: tier1 for k in kernels}, failures,
                     label)
        line("(b)", label[4:], off, on, ok, w)
        if not w["stage_us"]["quarantine"] > 0:
            failures.append(f"walls {label}: quarantine empty "
                            f"{w['stage_us']}")
        del off, on
    gc.collect()
    torch.cuda.empty_cache()
    # -- (c) hierarchical, groupwise secagg, DnC -------------------------------
    cfg = hier_config("Krum", "Krum")
    off, on, ok = pair(walls_cfg(cfg), cfg, ("krum_scores",),
                       "(c) hier Krum/Krum")
    w = walls_of(on["exp"], {"krum_scores": ("tier1_aggregate",
                                             "tier2_aggregate")},
                 failures, "(c) hier Krum/Krum")
    both = sorted(w["kernels"].get("krum_scores", {}))
    line("(c)", "hier Krum/Krum", off, on, ok, w,
         f"krum_scores in {both} ")
    if both != ["tier1_aggregate", "tier2_aggregate"]:
        failures.append(f"walls (c) hier Krum/Krum: krum_scores in {both}")
    del off, on
    cfg = hier_config("NoDefense", "Krum", secagg="groupwise")
    secagg = ("krum_scores", "secagg_deltas", "secagg_unmask_sum")
    off, on, ok = pair(walls_cfg(cfg), cfg, secagg, "(c) groupwise")
    w = walls_of(on["exp"], {"secagg_deltas": ("protect",),
                             "secagg_unmask_sum": ("protect",),
                             "krum_scores": ("tier2_aggregate",)},
                 failures, "(c) groupwise NoDefense/Krum")
    line("(c)", "groupwise NoDefense/Krum", off, on, ok, w)
    del off, on
    gc.collect()
    torch.cuda.empty_cache()
    cfg = main_config("DnC", 0.24)
    off, on, ok = pair(walls_cfg(cfg), cfg, ("threefry_bits",), "(c) DnC")
    w = walls_of(on["exp"], {"threefry_bits": tier1}, failures, "(c) DnC")
    line("(c)", "DnC", off, on, ok, w)
    del off, on
    # -- (d) the cost report ----------------------------------------------------
    cfg = main_config("Krum", 0.24)
    lines, ledger = [], {}

    def report(exp):
        logger = RunLogger(exp.cfg, log_dir=None, log=lines.append)
        ledger["ledger"] = exp.cost_report(logger)
        ledger["events"] = logger.events

    off, on, ok = pair(walls_cfg(cfg), cfg, ("krum_scores",),
                       "(d) cost report", before=report)
    led, evs = ledger["ledger"], ledger["events"]
    for e in evs:
        validate_event(e)
    n, d, f = N_MAIN, D_MLP, F_MAIN
    # PERF.md's table bound for kernel 2 at (n, d): its operations and
    # bytes, written out.
    want = {"krum_scores": (n * (n - 1) * d + 2 * n * d, 4 * n * d + 8 * n)}
    names = [r.name for r in led.records]
    per_kind = {k: sorted(e["name"] for e in evs if e["kind"] == k)
                for k in ("cost", "stage_cost")}
    counts_ok, peaks_ok = True, True
    for rec in led.records:
        peaks_ok &= rec.peak_allocated is not None and rec.peak_bytes > 0
        for kname, row in rec.kernels.items():
            fl, by = want[kname]
            counts_ok &= (row["flops"] == row["calls"] * fl
                          and row["bytes_accessed"] == row["calls"] * by)
        share = rec.attribution["coverage"]
        print(f"[walls] (d) [cost] {rec.name:14s} flops={rec.flops:.4e} "
              f"bytes={rec.bytes_accessed:.4e} peak_bytes={rec.peak_bytes} "
              f"(allocator) named_share flops/bytes="
              f"{share['flops']:.4f}/{share['bytes_accessed']:.4f} stages="
              f"{ {k: round(v['flops'] / 1e9, 4) for k, v in rec.attribution['stages'].items()} } "
              f"GFLOP kernels="
              f"{ {k: (v['calls'], v['flops'], v['bytes_accessed']) for k, v in rec.kernels.items()} }",
              flush=True)
    structure_ok = (
        names == ["fused_round", "fused_span", "compute_grads",
                  "defense_Krum", "eval"]
        and per_kind["cost"] == sorted(names)
        and per_kind["stage_cost"] == sorted(names)
        and sum(e["kind"] == "wire_bytes" for e in evs) == 1
        and not led.errors
        and led.records[0].kernels["krum_scores"]["calls"] == 1
        and led.records[1].kernels["krum_scores"]["calls"] == TEST_STEP)
    compiles = {r.name: (round(r.compile_s, 2), r.cache)
                for r in led.compiles}
    d_ok = ok and structure_ok and counts_ok and peaks_ok
    if not d_ok:
        failures.append(f"walls (d) cost report: structure={structure_ok} "
                        f"counts={counts_ok} peaks={peaks_ok} twin={ok} "
                        f"errors={led.errors}")
    # The captures beside the counted stage shares, as the CLI prints
    # them with --cost-report and --profile-every.
    from attacking_federate_learning_tpu_torch.cli import (
        print_walls_vs_modeled
    )
    print_walls_vs_modeled(on["exp"], led, lambda s: print(
        f"[walls] (d) vs modeled: {s[len('[walls] '):]} on {smi}",
        flush=True))
    print(f"[walls] (d) cost report entries={names} kernel_counts_equal_"
          f"table_formula={counts_ok} peaks_from_allocator={peaks_ok} "
          f"compile={compiles} wire={led.wire['total_bytes']} bytes a "
          f"round byte_equal_off_twin_after_report={ok} round_ms "
          f"(captured)={on['median_ms']:.3f} off_twin={off['median_ms']:.3f}"
          f" on {smi}",
          flush=True)
    del off, on, led
    # -- (e) the walls' own cost, with the phase timer ---------------------------
    from attacking_federate_learning_tpu_torch.utils.profiling import (
        PhaseTimer
    )
    off, on, ok = pair(walls_cfg(cfg, every=2), cfg, ("krum_scores",),
                       "(e) Krum every 2", timer=PhaseTimer())
    profile = [e["phases"] for e in on["events"] if e["kind"] == "profile"]
    # Each interval's host wall a round: (first round, rounds, ms); the
    # captured ones are those with a trace under walltrace/r<first>.
    spans = [(int(e["round"]), int(e["rounds"]),
              1e3 * e["wall_s"] / e["rounds"]) for e in on["events"]
             if e["kind"] == "wall" and e["source"] == "host"
             and e["name"] == "fused_span"]
    traced = {int(os.path.basename(r.trace_dir)[1:])
              for r in on["exp"].wall_records}
    cap = [sp for sp in spans if sp[0] in traced]
    unc = [sp for sp in spans if sp[0] not in traced]
    unc_rounds = [t for r0, c, _ in unc for t in range(r0, r0 + c)]
    e_ok = (ok and len(spans) == 3 and len(traced) == 2 and bool(unc_rounds)
            and len(profile) == 1
            and profile[0]["round"]["count"] == ROUNDS)
    if not e_ok:
        failures.append(f"walls (e): spans {spans}, captures {traced}")
        unc_rounds = unc_rounds or [0]
    on_ms = statistics.median(on["round_ms"][t] for t in unc_rounds)
    off_ms = statistics.median(off["round_ms"][t] for t in unc_rounds)
    print(f"[walls] (e) Krum profile_every=2 uncaptured rounds "
          f"{unc_rounds[0]}..{unc_rounds[-1]}: median round ms "
          f"{on_ms:.3f} against the off twin's {off_ms:.3f} on the same "
          f"rounds (host clock); host walls a round by interval (start, "
          f"rounds, ms): captured {[(a, b, round(c, 3)) for a, b, c in cap]}"
          f" uncaptured {[(a, b, round(c, 3)) for a, b, c in unc]} "
          f"timer={profile[0] if profile else None} "
          f"byte_equal_and_launches_twin={ok} on {smi}", flush=True)
    del off, on
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[walls] phase 16 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals


# -- phase 17: the host engines and host streaming ------------------------------
# (a): (label, defense, knobs, the card twin's knobs, must launch, must not
# launch), mnist_mlp at phase 5's width, f = 24, 21 rounds.
P17_RUNS = (
    ("Krum distance_impl=host", "Krum", dict(distance_impl="host"), {},
     (), ("krum_scores", "pairwise_distances")),
    ("Bulyan selection=host", "Bulyan", dict(bulyan_selection_impl="host"),
     {}, ("pairwise_distances", "trimmed_mean"), ()),
    ("Bulyan selection=host trim=host", "Bulyan",
     dict(bulyan_selection_impl="host", bulyan_trim_impl="host"), {},
     ("pairwise_distances",), ("trimmed_mean",)),
    ("Bulyan selection=host q=4", "Bulyan",
     dict(bulyan_selection_impl="host", bulyan_batch_select=4),
     dict(bulyan_batch_select=4), ("pairwise_distances", "trimmed_mean"),
     ()),
    ("TrimmedMean host", "TrimmedMean", dict(trimmed_mean_impl="host"), {},
     (), ("trimmed_mean",)),
    ("Median host", "Median", dict(median_impl="host"), {}, (),
     ("median",)),
)
# (b): flat Bulyan at batch 32, f at 24 %, the hybrid beside the card's
# route; the card route's second round is skipped past this many seconds.
P17_LARGE_N = (1_000, 10_000)
P17_BATCH = 32
P17_CARD_ROUND_LIMIT_S = 30.0
# (c): (defense, stream_prefetch, stream_workers) for each cohort set.
P17_STREAMS = tuple((d, p, w) for d in ("Krum", "TrimmedMean")
                    for p in (1, 2) for w in (0, 1))
P17_STREAM_SETS = (("full", {}),
                   ("p0.6 femnist_style",
                    dict(participation=0.6, partition="femnist_style")))


def p17_scores64(G, pool, k):
    """Each row's Krum score over ``pool`` (an (n,) bool on the card) in
    fp64: the sum of its k smallest distances to the other pool rows,
    from an fp64 Gram of G; +inf outside the pool."""
    import torch

    G64 = G.double()
    sq = (G64 * G64).sum(1)
    D = (sq[:, None] + sq[None, :] - 2.0 * (G64 @ G64.T)).clamp_min(0.0)
    D = D.sqrt()
    del G64
    n = D.shape[0]
    D.fill_diagonal_(math.inf)
    D[:, ~pool] = math.inf
    s = torch.sort(D, dim=1).values[:, :k].sum(1)
    del D
    return torch.where(pool, s, math.inf)


def p17_canonical(sel, G, m_mal):
    """The picks with ALIE's identical crafted rows [0, m_mal) as one
    client (either route may take them in another order)."""
    import torch

    sel = np.asarray(sel, np.int64)
    if m_mal > 1 and bool(torch.equal(G[:m_mal], G[:1].expand(m_mal, -1))):
        return np.where(sel < m_mal, 0, sel)
    return sel


def p17_selection_verdict(G, got, want, n, f, q, m_mal):
    """Hold the host selection ``got`` against the card route's ``want``
    (selection order): equal up to the crafted copies, or at the first
    trip where they part a near-tie by utils/numerics.py:adjudicate of
    the two picks' fp64 scores against the fp64 oracle's; returns the
    adjudicate record (verdict 'exact' when equal) and that trip."""
    import torch

    from attacking_federate_learning_tpu_torch.utils.numerics import (
        adjudicate
    )

    a, b = p17_canonical(got, G, m_mal), p17_canonical(want, G, m_mal)
    diff = np.nonzero(a != b)[0]
    if diff.size == 0:
        return adjudicate(np.zeros(1), np.zeros(1), np.zeros(1)), None
    t = int(diff[0]) // q
    r = min(q, len(got) - t * q)
    pool = torch.ones(n, dtype=torch.bool, device=G.device)
    pool[torch.as_tensor(np.asarray(got[:t * q], np.int64),
                         device=G.device)] = False
    s64 = p17_scores64(G, pool, n - t * q - f).cpu().numpy()
    pick = slice(t * q, t * q + r)
    sa = np.sort(s64[np.asarray(got)[pick]])
    sb = np.sort(s64[np.asarray(want)[pick]])
    oracle = np.sort(s64)[:r]
    return adjudicate(sa.astype(np.float32), sb.astype(np.float32),
                      oracle), t


class p17_patch:
    """Replace ``module.name`` by ``wrap(original)`` for the block."""

    def __init__(self, module, name, wrap):
        self.module, self.name, self.wrap = module, name, wrap

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.wrap(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def p17_host_checked(exp, twin, excluded, recs, defense, q, trim_host):
    """Wrap the host engine's defense so that every call is held against
    the card route's (the twin engine's defense on the same matrix, its
    launches not counted): Krum's winning row byte-equal, Bulyan's picks
    equal up to the crafted copies or a near-tie adjudicated in fp64,
    aggregates byte-equal where the picks are (the same trim kernel), the
    host trim and TrimmedMean within phase 8's band (2 n eps max |g|),
    Median exact.  On the first call the native library is held against
    its NumPy plain version on the run's matrix (:func:`p17_native_vs_plain`).
    Each call's record goes to ``recs``, the check's seconds to
    ``excluded``."""
    import torch

    from attacking_federate_learning_tpu_torch.defenses import host as H
    from attacking_federate_learning_tpu_torch.defenses import kernels as K
    from attacking_federate_learning_tpu_torch.ops import _build

    inner, card = exp.defense_fn, twin.defense_fn
    eps = float(np.finfo(np.float32).eps)

    def checked(grads, n, f, **kw):
        picks = {}

        def keep(name):
            def wrap(fn):
                def spy(*a, **k):
                    out = fn(*a, **k)
                    picks.setdefault(name, out)
                    return out
                return spy
            return wrap

        with p17_patch(K, "host_bulyan_selection_of", keep("host")), \
                p17_patch(K, "host_krum_select", keep("host")):
            out = inner(grads, n, f, **kw)
        torch.cuda.synchronize()
        a = time.perf_counter()
        # The checks' own launches are no launches of the run.
        snap = dict(_build.LAUNCHES)
        with p17_patch(K, "bulyan_select", keep("card")):
            want = card(grads, n, f, **kw)
        rec = {"verdict": "exact", "agg_ok": True, "agg_err": 0.0}
        G = grads.float()
        if defense == "Krum":
            if not byte_equal(out, want):
                won = int(torch.nonzero((G == want.float()).all(1))[0])
                rec = {**p17_selection_verdict(
                    G, [picks["host"]], [won], n, f, 1, exp.m_mal)[0],
                    "agg_ok": True, "agg_err": float((out - want).abs().max())}
        elif defense == "Bulyan":
            got_sel = picks["host"].cpu().numpy()
            want_sel = picks["card"].cpu().numpy()
            v, trip = p17_selection_verdict(G, got_sel, want_sel, n, f, q,
                                            exp.m_mal)
            rec = {**v, "trip": trip, "agg_ok": True, "agg_err": 0.0}
            err = float((out - want).abs().max())
            band = 2.0 * n * eps * float(G.abs().max())
            if v["verdict"] == "exact":
                rec["agg_err"] = err
                rec["agg_ok"] = (err <= band) if trim_host else byte_equal(
                    out, want)
            if not recs:
                rec["native"] = p17_native_vs_plain(G, picks["host"], n, f,
                                                    q)
        else:
            err = float((out - want).abs().max())
            band = (0.0 if defense == "Median"
                    else 2.0 * n * eps * float(G.abs().max()))
            rec["agg_err"], rec["agg_ok"] = err, err <= band
            if not recs:
                Gh = G.cpu().numpy()
                if defense == "Median":
                    plain = np.median(Gh, 0).astype(np.float32)
                    nat = H.host_median(Gh)
                    rec["native"] = {"median_equal_np": bool(
                        np.array_equal(nat, plain))}
                else:
                    keep_k = n - f - 1
                    nat = H.host_trimmed_mean_of(Gh, keep_k)
                    plain = p17_numpy_trimmed_mean(Gh, keep_k)
                    rec["native"] = {"trim_vs_np_max_abs": float(
                        np.abs(nat - plain).max()), "trim_band": band,
                        "ok": bool(np.abs(nat - plain).max() <= band)}
        torch.cuda.synchronize()
        _build.LAUNCHES.update(snap)
        recs.append(rec)
        excluded.append(time.perf_counter() - a)
        return out

    exp.defense_fn = checked


def p17_numpy_trimmed_mean(G, k):
    """The trimmed mean's NumPy formulation (defenses/host.py's for a
    non-finite matrix): the native kernel's plain version."""
    med = np.median(G, axis=0)
    dev = G - med
    order = np.argsort(np.abs(dev), axis=0, kind="stable")
    return (np.take_along_axis(dev, order[:k], axis=0).mean(axis=0)
            + med).astype(np.float32)


def p17_native_vs_plain(G, selected, n, f, q):
    """The native selection against numpy_bulyan_selection on the run's
    own (n, n) matrix (the distance kernel's, +inf diagonal), and the
    native trimmed mean of the selection against its NumPy plain
    version: equal picks (or an fp64-adjudicated near-tie), the trim
    within 2 n eps max |g|."""
    import torch

    from attacking_federate_learning_tpu_torch.defenses import host as H
    from attacking_federate_learning_tpu_torch.defenses import kernels as K

    D = K.distances_for(G)
    D.fill_diagonal_(math.inf)
    Dh = D.cpu().numpy()
    order = np.argsort(Dh, axis=1).astype(np.int32)
    set_size = n - 2 * f
    nat = H.host_bulyan_selection(Dh, n, f, set_size, batch_select=q)
    plain = H.numpy_bulyan_selection(Dh, order, n, f, set_size,
                                     batch_select=q)
    same = bool(np.array_equal(nat, plain))
    verdict = "exact"
    if not same:
        verdict = p17_selection_verdict(G, nat, plain, n, f, q, 0)[0][
            "verdict"]
    same_as_run = bool(np.array_equal(nat, selected.cpu().numpy()))
    sel = G[torch.as_tensor(nat.astype(np.int64),
                            device=G.device)].cpu().numpy()
    keep = set_size - 2 * f - 1
    trim = H.host_trimmed_mean_of(sel, keep)
    err = float(np.abs(trim - p17_numpy_trimmed_mean(sel, keep)).max())
    band = 2.0 * set_size * float(np.finfo(np.float32).eps) * float(
        np.abs(sel).max())
    return {"selection_vs_np": verdict, "same_as_run": same_as_run,
            "trim_vs_np_max_abs": err,
            "ok": verdict in ("exact", "tie_band") and same_as_run
            and err <= band}


def p17_config(defense, n=N_MAIN, batch=128, mal_prop=0.24, epochs=ROUNDS,
               **kw):
    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.config import ExperimentConfig

    kw.setdefault("dataset", C.SYNTH_MNIST)
    kw.setdefault("synth_train", 60_000)
    kw.setdefault("synth_test", 10_000)
    return ExperimentConfig(users_count=n, mal_prop=mal_prop,
                            batch_size=batch, epochs=epochs, num_std=1.5,
                            learning_rate=0.1, momentum=0.9,
                            defense=defense, test_step=TEST_STEP, **kw)


def p17_large(n, ds_n, failures, smi, totals):
    """(b): flat Bulyan at n, batch 32, f at 24 %: the hybrid (its split
    by CUDA events and the host clock) and the card's route, 2 rounds
    each (the card route's second only within P17_CARD_ROUND_LIMIT_S)."""
    import torch

    from attacking_federate_learning_tpu_torch import native as NT
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.defenses import host as H
    from attacking_federate_learning_tpu_torch.defenses import kernels as K
    from attacking_federate_learning_tpu_torch.ops import _build

    split = {k: [] for k in ("distance_ms", "d2h_ms", "d2h_mb",
                             "select_host_ms", "native_ms", "trim_ms")}
    picks = {"host": [], "card": []}
    keep_G = []

    def events(key):
        def wrap(fn):
            def timed(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                split[key].append((e0, e1))
                return out
            return timed
        return wrap

    def host_clock(key, sync=False):
        def wrap(fn):
            def timed(*a, **k):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                split[key].append(1e3 * (time.perf_counter() - t0))
                if key == "d2h_ms":
                    split["d2h_mb"].append(a[0].numel() * 4 / 1e6)
                return out
            return timed
        return wrap

    def keep(name):
        def wrap(fn):
            def spy(*a, **k):
                out = fn(*a, **k)
                picks[name].append(out.cpu().numpy())
                return out
            return spy
        return wrap

    def first_grads(fn):
        def spy(G, *a, **k):
            if not keep_G:
                keep_G.append(G)
            return fn(G, *a, **k)
        return spy

    def rounds(exp, count, limit=None):
        ms = []
        for t in range(count):
            torch.cuda.synchronize()
            a = time.perf_counter()
            exp.run_round(t)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - a))
            if limit is not None and ms[-1] > 1e3 * limit:
                break
        return ms

    cfg_h = p17_config("Bulyan", n=n, batch=P17_BATCH, epochs=2,
                       synth_train=len(ds_n.train_y),
                       bulyan_selection_impl="host")
    cfg_c = p17_config("Bulyan", n=n, batch=P17_BATCH, epochs=2,
                       synth_train=len(ds_n.train_y))
    hyb = FederatedExperiment(cfg_h, DriftAttack(cfg_h.num_std), ds_n,
                              device="cuda")
    f = hyb.f
    _build.reset_launches()
    with p17_patch(K, "distances_for", events("distance_ms")), \
            p17_patch(K, "distances_for", first_grads), \
            p17_patch(K, "host_array", host_clock("d2h_ms", sync=True)), \
            p17_patch(H, "host_bulyan_selection",
                      host_clock("select_host_ms")), \
            p17_patch(NT, "native_bulyan_selection",
                      host_clock("native_ms")), \
            p17_patch(K, "trim_of", events("trim_ms")), \
            p17_patch(K, "host_bulyan_selection_of", keep("host")):
        hyb_ms = rounds(hyb, 2)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for k, v in launches.items():
        totals[k] += v
    G = keep_G[0]
    w_h = [hyb.state.weights.clone(), hyb.state.velocity.clone()]
    del hyb
    gc.collect()
    torch.cuda.empty_cache()
    card = FederatedExperiment(cfg_c, DriftAttack(cfg_c.num_std), ds_n,
                               device="cuda")
    with p17_patch(K, "bulyan_select", keep("card")):
        card_ms = rounds(card, 2, limit=P17_CARD_ROUND_LIMIT_S)
    same_w = (len(card_ms) == 2 and byte_equal(w_h[0], card.state.weights)
              and byte_equal(w_h[1], card.state.velocity))
    del card
    gc.collect()
    torch.cuda.empty_cache()
    verdicts = []
    for t in range(min(len(picks["host"]), len(picks["card"]))):
        if t > 0 and not verdicts[0]["verdict"] == "exact":
            break                  # the two runs' weights parted
        v, trip = (p17_selection_verdict(G, picks["host"][t],
                                         picks["card"][t], n, f, 1, f)
                   if t == 0 else ({"verdict": "exact"
                                    if np.array_equal(picks["host"][t],
                                                      picks["card"][t])
                                    else "differs"}, None))
        verdicts.append({**v, "trip": trip})
    sel_ok = all(v["verdict"] in ("exact", "tie_band") for v in verdicts)
    must = ("pairwise_distances", "trimmed_mean")
    launch_ok = all(launches[k] == 2 for k in must)
    if not (sel_ok and launch_ok):
        failures.append(f"hostpath (b) n={n}: selections {verdicts}, "
                        f"launches {launches}")

    def ms(key):
        return [round(e0.elapsed_time(e1), 3) for e0, e1 in split[key]]

    print(f"[hostpath] (b) Bulyan n={n} f={f} batch={P17_BATCH} hybrid "
          f"round_ms={[round(x, 3) for x in hyb_ms]} distance_ms="
          f"{ms('distance_ms')} d2h_ms={[round(x, 3) for x in split['d2h_ms']]}"
          f" d2h_MB={split['d2h_mb']} select_host_ms (argsort + native)="
          f"{[round(x, 3) for x in split['select_host_ms']]} native_ms="
          f"{[round(x, 3) for x in split['native_ms']]} trim_ms="
          f"{ms('trim_ms')} launches={ {k: v for k, v in launches.items() if v} }"
          f"; card route round_ms={[round(x, 3) for x in card_ms]}"
          + (f" (second round skipped: the first took over "
             f"{P17_CARD_ROUND_LIMIT_S:.0f} s)" if len(card_ms) < 2 else "")
          + f"; selections {[v['verdict'] for v in verdicts]} "
          f"weights_byte_equal_after_2={same_w} on {smi}", flush=True)


def run_hostpath(ds, failures, smi):
    """Phase 17: the host engines and host streaming through the port's
    entry points on the card.  (a) the host engines at the main path's
    width (P17_RUNS, each beside its twin on the card's route; every
    call held against the card route, the native library against its
    NumPy plain version on the run's matrices); (b) the hybrid exact
    Bulyan at n = 1,000 and 10,000 and its split; (c) host streaming
    (P17_STREAMS x P17_STREAM_SETS and cifar10_cnn with augmentation),
    every run byte-equal to its device-placed twin, with its stall
    record.  Returns launches per kernel summed over the runs."""
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    totals = {name: 0 for name in _build.LAUNCHES}
    a = time.perf_counter()
    lib = _build.build_host_library("bulyan_select")
    print(f"[hostpath] native library {lib.name} built or found with g++ "
          f"in {time.perf_counter() - a:.2f} s", flush=True)

    def add(run):
        for k, v in run["launches"].items():
            totals[k] += v

    # -- (a) the host engines at the main path's width ----------------------
    for label, defense, knobs, twin_knobs, kernels, banned in P17_RUNS:
        twin = FederatedExperiment(p17_config(defense, **twin_knobs),
                                   DriftAttack(1.5), ds, device="cuda")
        exp = FederatedExperiment(p17_config(defense, **knobs),
                                  DriftAttack(1.5), ds, device="cuda")
        recs, excluded = [], []
        q = knobs.get("bulyan_batch_select", 1)
        trim_host = knobs.get("bulyan_trim_impl") == "host"
        p17_host_checked(exp, twin, excluded, recs, defense, q, trim_host)
        run = drive(exp, kernels, banned, failures, f"hostpath {label}",
                    excluded=excluded)
        add(run)
        twin_run = drive(twin, (), (), failures, f"hostpath {label} twin")
        add(twin_run)
        verdicts = [r["verdict"] for r in recs]
        ties = sum(v == "tie_band" for v in verdicts)
        sel_ok = all(v in ("exact", "tie_band") for v in verdicts)
        agg_ok = all(r["agg_ok"] for r in recs)
        native = recs[0].get("native") if recs else None
        native_ok = native is None or native.get("ok", True) and all(
            v for k, v in native.items() if k == "median_equal_np")
        exact_run = (ties == 0 and not trim_host
                     and defense != "TrimmedMean")
        same = same_state(exp, twin)
        dw = float((exp.state.weights - twin.state.weights).abs().max())
        if not (sel_ok and agg_ok and native_ok and len(recs) == ROUNDS
                and (same or not exact_run)):
            failures.append(f"hostpath (a) {label}: verdicts {verdicts}, "
                            f"aggregates ok={agg_ok}, native {native}, "
                            f"checked {len(recs)}, byte_equal_twin={same}")
        print(f"[hostpath] (a) {label} f={exp.f} acc r0/r10/r20 = "
              f"{run['acc_txt']} % median_round_ms={run['median_ms']:.3f} "
              f"(card twin {twin_run['median_ms']:.3f}) launches="
              f"{ {k: v for k, v in run['launches'].items() if v} } "
              f"(twin { {k: v for k, v in twin_run['launches'].items() if v} })"
              f" selections exact/tie_band {verdicts.count('exact')}/{ties} "
              f"of {len(recs)} max_agg_err="
              f"{max((r['agg_err'] for r in recs), default=0.0):.3g} "
              f"native_vs_plain={native} byte_equal_twin={same} "
              f"max_abs_dw={dw:.3g} on {smi}", flush=True)
        del exp, twin, run, twin_run
    gc.collect()
    torch.cuda.empty_cache()
    # -- (b) the hybrid at large n --------------------------------------------
    for n in P17_LARGE_N:
        a = time.perf_counter()
        ds_n = (ds if n * P17_BATCH <= len(ds.train_y) else load_dataset(
            C.SYNTH_MNIST, seed=0, synth_train=n * P17_BATCH,
            synth_test=10_000))
        if ds_n is not ds:
            print(f"[hostpath] SYNTH_MNIST {n * P17_BATCH}/10000 made in "
                  f"{time.perf_counter() - a:.1f} s", flush=True)
        p17_large(n, ds_n, failures, smi, totals)
        del ds_n
        gc.collect()
        torch.cuda.empty_cache()
    # -- (c) host streaming ---------------------------------------------------
    kernel_of = {"Krum": ("krum_scores",), "TrimmedMean": ("trimmed_mean",)}
    cells = [(set_label, extra, d, p, w) for set_label, extra in
             P17_STREAM_SETS for d, p, w in P17_STREAMS]
    twins = {}
    for set_label, extra, defense, prefetch, workers in cells:
        key = (set_label, defense)
        if key not in twins:
            twin = FederatedExperiment(p17_config(defense, **extra),
                                       DriftAttack(1.5), ds, device="cuda")
            twins[key] = (twin, drive(twin, kernel_of[defense], (), failures,
                                      f"hostpath stream twin {key}"))
            add(twins[key][1])
        twin, twin_run = twins[key]
        exp = FederatedExperiment(
            p17_config(defense, data_placement="host_stream",
                       stream_prefetch=prefetch, stream_workers=workers,
                       **extra), DriftAttack(1.5), ds, device="cuda")
        run = drive(exp, kernel_of[defense], (), failures,
                    f"hostpath stream {set_label} {defense}")
        add(run)
        stats = exp.stream.stall_stats()
        exp.stream.close()
        same = same_state(exp, twin)
        if not same:
            failures.append(f"hostpath (c) {set_label} {defense} prefetch="
                            f"{prefetch} workers={workers}: weights differ "
                            f"from the device twin's")
        print(f"[hostpath] (c) {set_label} {defense} prefetch={prefetch} "
              f"workers={workers} median_round_ms={run['median_ms']:.3f} "
              f"(device twin {twin_run['median_ms']:.3f}) deliver_ms="
              f"{run['deliver_ms']:.3f} (twin {twin_run['deliver_ms']:.3f})"
              f" stall_per_get_ms={stats['stream_stall_per_get_ms']} "
              f"gets={stats['stream_gets']} cold_misses="
              f"{stats['stream_cold_misses']} byte_equal_device_twin={same} "
              f"on {smi}", flush=True)
        del exp, run
    del twins
    gc.collect()
    torch.cuda.empty_cache()
    # cifar10_cnn with augmentation
    a = time.perf_counter()
    ds_c = load_dataset(C.SYNTH_CIFAR10, seed=0, synth_train=20_000,
                        synth_test=2_000)
    made = time.perf_counter() - a
    ccfg = dict(dataset=C.SYNTH_CIFAR10, synth_train=20_000,
                synth_test=2_000, data_augment=True)
    twin = FederatedExperiment(p17_config("TrimmedMean", batch=32, **ccfg),
                               DriftAttack(1.5), ds_c, device="cuda")
    twin_run = drive(twin, ("trimmed_mean",), (), failures,
                     "hostpath stream cifar twin")
    add(twin_run)
    exp = FederatedExperiment(
        p17_config("TrimmedMean", batch=32, data_placement="host_stream",
                   stream_prefetch=2, stream_workers=1, **ccfg),
        DriftAttack(1.5), ds_c, device="cuda")
    run = drive(exp, ("trimmed_mean",), (), failures,
                "hostpath stream cifar")
    add(run)
    stats = exp.stream.stall_stats()
    exp.stream.close()
    same = same_state(exp, twin)
    if not same:
        failures.append("hostpath (c) cifar10_cnn augmented: weights "
                        "differ from the device twin's")
    print(f"[hostpath] (c) cifar10_cnn augmented TrimmedMean batch 32 "
          f"(SYNTH_CIFAR10 20000 made in {made:.1f} s) prefetch=2 workers=1"
          f" median_round_ms={run['median_ms']:.3f} (device twin "
          f"{twin_run['median_ms']:.3f}) stall_per_get_ms="
          f"{stats['stream_stall_per_get_ms']} cold_misses="
          f"{stats['stream_cold_misses']} byte_equal_device_twin={same} on "
          f"{smi}", flush=True)
    del exp, twin, run, twin_run, ds_c
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[hostpath] phase 17 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals


# -- phase 18: campaigns and the run readers ---------------------------------
# (a): the campaign's axes over phase 5's configuration (the five defenses
# under ALIE and under 'none', rounds 0..20), and its explicit cells: phase
# 5's faulted TrimmedMean and Median (f = 10), phase 10 (a)'s async
# TrimmedMean 'poly' (k = 64), phase 13 (a)'s hierarchical Bulyan /
# TrimmedMean at n = 1,000, S = 10 with the tier-2 forensics stream, and
# Bulyan at f = 25 (n < 4f + 3: skipped, never run).
P18_DEFENSES = ("NoDefense", "Krum", "TrimmedMean", "Bulyan", "Median")
P18_EXTRA = (
    dict(defense="TrimmedMean", mal_prop=0.1, faults=FAULTS_MAIN,
         attack="alie"),
    dict(defense="Median", mal_prop=0.1, faults=FAULTS_MAIN, attack="alie"),
    dict(defense="TrimmedMean", aggregation="async", async_buffer=64,
         async_max_staleness=P10_STALENESS, staleness_weight="poly",
         attack="alie"),
    dict(defense="Bulyan", users_count=N_HIER, batch_size=B_HIER,
         epochs=P13_ROUNDS, test_step=5, aggregation="hierarchical",
         megabatch=M_HIER, tier2_defense="TrimmedMean", telemetry=True,
         attack="alie"),
    dict(defense="Bulyan", mal_prop=0.25, attack="alie"),
)
# Must launch and must not launch, by (defense, attack, kind).  Every
# other kernel of the six must not launch either.
P18_MUST = {
    "NoDefense": (), "Krum": ("krum_scores",),
    "Krum f0": ("pairwise_distances",), "TrimmedMean": ("trimmed_mean",),
    "Bulyan": ("pairwise_distances", "trimmed_mean"),
    "Median": ("median",), "TrimmedMean faulted": ("masked_trimmed_mean",),
    "Median faulted": ("masked_median",),
    "TrimmedMean async": ("masked_trimmed_mean",),
    "Bulyan hier": ("pairwise_distances", "trimmed_mean"),
}
# (b): the cells run again under the supervisor, one preempted at round 10.
P18_SUPERVISED = (("Krum", "alie", None), ("TrimmedMean faulted", "alie",
                                           None), ("Median", "alie", 10))
P18_KILL_CELLS = ("NoDefense", "Krum", "Median")   # (c), rounds 0..1
P18_MEM_SLACK = 2 * 2 ** 20       # bytes a cell may leave above the rest


def p18_base(root, **kw):
    """Phase 5's configuration as campaign-spec kwargs."""
    from attacking_federate_learning_tpu_torch import config as C

    return dict(dict(dataset=C.SYNTH_MNIST, users_count=N_MAIN,
                     mal_prop=0.24, batch_size=128, epochs=ROUNDS,
                     num_std=1.5, learning_rate=0.1, momentum=0.9,
                     test_step=TEST_STEP, synth_train=60_000,
                     synth_test=10_000,
                     log_dir=os.path.join(root, "logs"),
                     run_dir=os.path.join(root, "runs")), **kw)


def p18_kind(cell):
    """The cell's key into P18_MUST."""
    cfg = cell.cfg
    if cfg.aggregation == "hierarchical":
        return cfg.defense + " hier"
    if cfg.aggregation == "async":
        return cfg.defense + " async"
    if cfg.faults is not None:
        return cfg.defense + " faulted"
    if cfg.defense == "Krum" and cfg.corrupted_count == 0:
        return "Krum f0"
    return cfg.defense


def p18_libraries(kernels):
    """The kernel libraries (csrc/ sources) a set of kernels loads."""
    from attacking_federate_learning_tpu_torch.ops import _build

    return {_build.KERNELS[k][0] for k in kernels}


def p18_inline(spec, failures):
    """(a): the campaign through the inline executor into a store of its
    own, the build directory a warm copy of _build/.  Returns (launches,
    per-cell engine records, per-cell manifest rows, the campaign, the
    allocator's rest before it, its wall seconds)."""
    import shutil

    import torch

    from attacking_federate_learning_tpu_torch.campaigns import Campaign
    from attacking_federate_learning_tpu_torch.campaigns.scheduler import (
        InlineExecutor
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    cache = os.path.join(os.path.dirname(spec.base["run_dir"]), "build")
    os.makedirs(cache)
    for p in _build.BUILD_DIR.glob("*.so"):
        shutil.copy2(p, cache)
    recs = {}

    def start(cell, exp):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recs[cell.cell_id] = {"before": dict(_build.LAUNCHES),
                              "t0": time.perf_counter()}

    def done(cell, exp):
        torch.cuda.synchronize()
        rec = recs[cell.cell_id]
        rec["launches"] = {k: v - rec["before"][k]
                           for k, v in _build.LAUNCHES.items()}
        rec["weights"] = exp.state.weights.detach().cpu().clone()
        rec["run_s"] = time.perf_counter() - rec["t0"]
        rec["peak"] = torch.cuda.max_memory_allocated()
        # Where the cell's libraries came from: the build directory set
        # while it ran, and the directory of each library it launched.
        rec["build_dir"] = str(_build.build_dir())
        rec["loaded_from"] = {os.path.dirname(_build._LOADED[k]._name)
                              for k, v in rec["launches"].items() if v}

    rows = {}

    def on_cell(cell, row):
        torch.cuda.synchronize()
        rows[cell.cell_id] = dict(row, allocated=torch.cuda.memory_allocated(),
                                  committed=time.perf_counter())

    ex = InlineExecutor("cuda", on_start=start, on_engine=done)
    camp = Campaign(spec, executor=ex, cache_dir=cache, on_cell=on_cell)
    # The campaign's own work: its plan, and each commit (the journal
    # record, the event, the manifest rewrite).
    a = time.perf_counter()
    camp.plan()
    bookkeeping = {"plan_s": time.perf_counter() - a, "commit_s": []}
    commit = camp._commit

    def timed_commit(*args, **kw):
        a = time.perf_counter()
        commit(*args, **kw)
        bookkeeping["commit_s"].append(time.perf_counter() - a)

    camp._commit = timed_commit
    gc.collect()
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = camp.run()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if rc != 0:
        failures.append(f"campaign (a): rc {rc}")
    return launches, recs, rows, camp, rest, wall, bookkeeping


def p18_direct(ds, cell):
    """The cell's config run directly, launch counters zeroed before and
    read after; returns (final weights on the host, launches, the run's
    seconds)."""
    import torch

    from attacking_federate_learning_tpu_torch.attacks import make_attacker
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    name = None if cell.attack == "auto" else cell.attack
    exp = FederatedExperiment(cell.cfg, make_attacker(cell.cfg, ds, name,
                                                      "cuda"),
                              ds, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    exp.run(log=lambda *_: None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    w = exp.state.weights.detach().cpu().clone()
    del exp
    gc.collect()
    return w, launches, run_s


def p18_supervised(spec, inline_recs, failures, smi):
    """(b): P18_SUPERVISED's cells as children under the supervisor, the
    build directory pointed at (a)'s through child_env; each child's
    final auto-checkpoint byte-equal to its inline twin's weights, its
    journal verified.  A child spends most of its life starting, so each
    cell is a one-cell campaign of its own, all three started together."""
    import threading

    import numpy as np

    from attacking_federate_learning_tpu_torch.campaigns import (
        Campaign, CampaignSpec
    )
    from attacking_federate_learning_tpu_torch.campaigns.scheduler import (
        SupervisorExecutor
    )
    from attacking_federate_learning_tpu_torch.utils.lifecycle import (
        RunJournal
    )

    root = os.path.dirname(spec.base["run_dir"])
    picks = [c for c in spec.expand()
             if not c.skip and (p18_kind(c), c.attack)
             in {(k, a) for k, a, _ in P18_SUPERVISED}]
    preempt = {c.cell_id: r for c in picks for k, a, r in P18_SUPERVISED
               if (p18_kind(c), c.attack) == (k, a) and r is not None}
    # A spec without axes runs its base as its one cell.
    dirs = dict(run_dir=os.path.join(root, "runs_b"),
                log_dir=os.path.join(root, "logs_b"))
    subs = [CampaignSpec(name=f"p18b{i}",
                         base=dict(c.overrides, attack=c.attack, **dirs))
            for i, c in enumerate(picks)]
    out, rcs = {}, {}

    def one(sub):
        camp = Campaign(sub, executor=SupervisorExecutor(
            "cuda", inject_preempt=preempt), cache_dir=os.path.join(
                root, "build"), on_cell=lambda cell, row: out.__setitem__(
                    cell.cell_id, row))
        rcs[sub.name] = (camp.run(), camp.journal.verify(
            [c.cell_id for c in sub.expand()]))

    threads = [threading.Thread(target=one, args=(sub,)) for sub in subs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if len(out) != len(P18_SUPERVISED) or any(
            rc != 0 or problems for rc, problems in rcs.values()):
        failures.append(f"campaign (b): {len(out)} cells, (rc, journal) "
                        f"{rcs}")
    for cell in picks:
        row = out.get(cell.cell_id, {})
        run_dir = os.path.join(dirs["run_dir"], cell.cell_id)
        autos = sorted(n for n in os.listdir(run_dir)
                       if n.startswith("checkpoint-auto-"))
        with np.load(os.path.join(run_dir, autos[-1])) as z:
            got = z["weights"]
        want = inline_recs[cell.cell_id]["weights"].numpy()
        same = got.dtype == want.dtype and np.array_equal(got, want)
        j = RunJournal(dirs["run_dir"], cell.cell_id)
        audit = j.verify(epochs=cell.cfg.epochs, test_step=cell.cfg.test_step)
        attempts = j.attempt
        j.close()
        if not same or audit or row.get("state") != "done":
            failures.append(f"campaign (b) {cell.cell_id}: byte_equal="
                            f"{same} audit={audit} state={row.get('state')}")
        print(f"[campaign] (b) supervised {p18_kind(cell):20s} "
              f"preempt_at={preempt.get(cell.cell_id)} attempts={attempts} "
              f"wall_s={row.get('wall_s')} (inline "
              f"{inline_recs[cell.cell_id]['run_s']:.2f}) cache_hits="
              f"{row.get('cache_hits')} cache_misses={row.get('cache_misses')}"
              f" final={autos[-1]} byte_equal_inline_twin={same} "
              f"journal_audit={'clean' if not audit else audit} on {smi}",
              flush=True)
    print(f"[campaign] (b) three supervised cells, started together, in "
          f"{wall:.1f} s (beside (c)'s two processes)", flush=True)


# A child process's start-up, step by step (run by p18_startup): the
# parent's clock at launch comes in as P18_T0.
P18_STARTUP = """
import json, os, sys, time
t = {"interpreter": time.time() - float(os.environ["P18_T0"])}
a = time.perf_counter()
import torch
t["import_torch"] = time.perf_counter() - a
a = time.perf_counter()
torch.zeros(1, device="cuda").sum().item()
t["device_init"] = time.perf_counter() - a
a = time.perf_counter()
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch.core import engine
from attacking_federate_learning_tpu_torch.campaigns import scheduler
t["import_port"] = time.perf_counter() - a
a = time.perf_counter()
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
load_dataset("SYNTH_MNIST", seed=0, synth_train=60000, synth_test=10000)
t["dataset"] = time.perf_counter() - a
from attacking_federate_learning_tpu_torch.ops import _build
a = time.perf_counter()
_build.entry_point("krum_scores")
t["load_library"] = time.perf_counter() - a
print(json.dumps(t))
"""


def p18_startup():
    """The seconds a fresh process of the port takes to start: the
    interpreter, torch's import, the device's first tensor, the port's
    modules, phase 5's dataset, one kernel library's load."""
    env = dict(os.environ, PYTHONPATH=ROOT, P18_T0=repr(time.time()))
    out = subprocess.run([sys.executable, "-c", P18_STARTUP],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        return {"error": out.stderr[-500:]}
    return json.loads(out.stdout.strip().splitlines()[-1])


def p18_kill(root, failures):
    """(c): a campaign process SIGKILLed once two cells are committed, and
    invoked again: each cell committed once, no duplicate registry
    stamp."""
    import json as _json
    import signal

    from attacking_federate_learning_tpu_torch.campaigns import (
        CampaignJournal, CampaignSpec
    )

    base = p18_base(os.path.join(root, "c"), epochs=2, test_step=1,
                    synth_train=N_MAIN * 128)
    blob = dict(name="p18c", base=base,
                axes={"defense": list(P18_KILL_CELLS), "attack": ["alie"]},
                order="spec")
    spec = CampaignSpec.from_json(_json.dumps(blob))
    path = os.path.join(root, "c_spec.json")
    with open(path, "w") as f:
        f.write(spec.to_json())
    cmd = [sys.executable, "-m", f"{PKG}.cli", "campaign", path,
           "--executor", "inline", "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    journal = os.path.join(base["run_dir"], "campaigns", spec.campaign_id,
                           "journal.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    committed = 0
    while proc.poll() is None and time.perf_counter() - t0 < 120:
        try:
            with open(journal) as f:
                committed = sum('"kind": "cell"' in line for line in f)
        except OSError:
            committed = 0
        if committed >= 2:
            proc.send_signal(signal.SIGKILL)
            break
        time.sleep(0.05)
    _, err = proc.communicate(timeout=60)
    killed = proc.returncode == -signal.SIGKILL
    first = time.perf_counter() - t0
    again = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
    j = CampaignJournal(base["run_dir"], spec.campaign_id)
    problems = j.verify([c.cell_id for c in spec.expand()])
    counts = (j.read_manifest() or {}).get("counts")
    by_attempt = {}
    for rec in j.records():
        if rec.get("kind") == "cell":
            by_attempt.setdefault(rec["attempt"], []).append(rec["cell"])
    with open(os.path.join(base["run_dir"], "index.jsonl")) as f:
        ids = [_json.loads(line)["run_id"] for line in f]
    ok = (killed and again.returncode == 0 and not problems
          and counts == {"done": len(P18_KILL_CELLS)}
          and len(ids) == len(set(ids)) == len(P18_KILL_CELLS))
    if not ok:
        failures.append(f"campaign (c): killed={killed} (rc "
                        f"{proc.returncode}) rerun rc {again.returncode} "
                        f"problems={problems} counts={counts} stamps={ids} "
                        f"{err[-500:]} {again.stderr[-1500:]}")
    print(f"[campaign] (c) SIGKILL after {committed} commits "
          f"({first:.1f} s), re-invoked ({again.returncode}) in "
          f"{time.perf_counter() - t0 - first:.1f} s: commits by attempt "
          f"{ {a: len(c) for a, c in by_attempt.items()} }, registry stamps "
          f"{len(ids)} ({len(set(ids))} distinct), journal "
          f"{'clean' if not problems else problems}", flush=True)


def p18_reader(fn, argv):
    """A reader's (rc, stdout lines), in this process."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = fn(argv)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue().splitlines()


def p18_observed(ds, root, failures):
    """The store's observatory run for (d): phase 5's Krum with the
    telemetry, margins and numerics flags and profile_every 10, journaled,
    after its cost report; its events kept in memory beside the log.
    Returns (exp, ledger, events, launches)."""
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.lifecycle import (
        RunJournal
    )
    from attacking_federate_learning_tpu_torch.utils.metrics import (
        RunLogger
    )

    cfg = ExperimentConfig(**p18_base(root, defense="Krum", telemetry=True,
                                      margins=True, numerics=True,
                                      profile_every=10))
    exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cuda")
    events = []
    with RunLogger(cfg, log_dir=cfg.log_dir, jsonl_name="p18_obs",
                   log=lambda *_: None) as logger:
        record = logger.record

        def tee(**fields):
            record(**fields)
            events.append(dict(fields))

        logger.record = tee
        ledger = exp.cost_report(logger)
        _build.reset_launches()
        exp.run(logger, journal=RunJournal(cfg.run_dir, "p18_obs"))
        launches = dict(_build.LAUNCHES)
    if launches["krum_scores"] != cfg.epochs:
        failures.append(f"campaign (d) observed run: launches {launches}")
    return exp, ledger, events, launches


def p18_readers(camp, obs, failures):
    """(d): the readers over (a)'s store, each held to what this process
    holds: the run manifests, the observatory run's wall records, cost
    ledger and margin and numerics series."""
    import json as _json

    from attacking_federate_learning_tpu_torch import report, runs_cli
    from attacking_federate_learning_tpu_torch.utils.margins import (
        margin_series
    )
    from attacking_federate_learning_tpu_torch.utils.numerics import (
        numerics_series
    )
    from attacking_federate_learning_tpu_torch.utils.registry import (
        RunRegistry
    )
    from attacking_federate_learning_tpu_torch.utils.trace_export import (
        validate_trace
    )

    exp, ledger, events, _ = obs
    run_dir = camp.run_dir
    head = ["--run-dir", run_dir, "--bench", "", "--progress", ""]
    # The index as the runs' stamps left it, then rebuilt from nothing.
    t0 = time.perf_counter()
    RunRegistry(run_dir).refresh(bench=[], progress=[])
    warm_s = time.perf_counter() - t0
    os.unlink(os.path.join(run_dir, "index.jsonl"))
    t0 = time.perf_counter()
    summary = RunRegistry(run_dir).refresh(bench=[], progress=[])
    refresh_s = time.perf_counter() - t0
    cells = [c for c in camp.plan() if not c.skip]
    manifests = {}
    for cid in [c.cell_id for c in cells] + ["p18_obs"]:
        with open(os.path.join(run_dir, cid, "manifest.json")) as f:
            manifests[cid] = _json.load(f)
    bad = []

    def run(argv, want_rc=0):
        rc, lines = p18_reader(runs_cli.main, head + argv)
        if rc != want_rc:
            bad.append(f"runs {' '.join(argv)}: rc {rc}")
        return lines

    def js(argv):
        lines = run(["--json"] + argv)
        return _json.loads(lines[-1]) if lines else None

    ents = {e["run_id"]: e for e in js(["list"])}
    for cid, man in manifests.items():
        e = ents.get(cid, {})
        if (e.get("final_accuracy") != man.get("final_accuracy")
                or e.get("rounds_per_s") != man.get("rounds_per_s")
                or e.get("status") != "done"):
            bad.append(f"list {cid}")
    some = [c.cell_id for c in cells[:3]]
    shown = js(["show", some[0]])
    if shown != RunRegistry(run_dir).resolve(some[0]):
        bad.append("show")
    diff = js(["diff", some[0], some[1]])
    if (diff is None or diff["a"] != some[0]
            or diff["trajectory"]["divergence_round"] is None):
        bad.append("diff")
    comp = js(["compare"] + some)
    if [e["final_accuracy"] for e in comp] != [
            manifests[c]["final_accuracy"] for c in some]:
        bad.append("compare")
    blob = js(["campaign", camp.spec.campaign_id])
    for key, recs in blob["table"]["cells"].items():
        for rec in recs:
            man = manifests.get(rec["cell"])
            if rec["state"] == "done" and (
                    man is None or rec["source"] != "registry"
                    or rec["final_accuracy"] != man["final_accuracy"]):
                bad.append(f"campaign {rec['cell']}")
            if rec["state"] == "skipped" and "4*corrupted_count" not in (
                    rec.get("reason") or ""):
                bad.append(f"campaign skip {rec['cell']}")
    kinds = {p18_kind(c): c.cell_id for c in cells}
    fx = js(["forensics", kinds["Bulyan hier"]])
    fx = next(iter(fx.values())) if fx else None
    if not fx or fx["rounds"] != P18_EXTRA[3]["epochs"]:
        bad.append("forensics")
    asy = js(["async", kinds["TrimmedMean async"]])
    if not asy or next(iter(asy.values()))["rounds"] != camp.spec.base[
            "epochs"]:
        bad.append("async")
    run(["traffic", kinds["TrimmedMean async"]], want_rc=1)
    walls = js(["walls", "p18_obs"])["p18_obs"]
    names = {r.name for r in exp.wall_records}
    if set(walls["entries"]) != names or not names:
        bad.append(f"walls names {sorted(walls['entries'])} vs "
                   f"{sorted(names)}")
    for name, agg in walls["entries"].items():
        recs = [r for r in exp.wall_records if r.name == name]
        if agg["captures"] != len(recs):
            bad.append(f"walls captures {name}")
    att = js(["attribution", "p18_obs"])["p18_obs"]
    want = {r.name for r in ledger.records if r.stage_event() is not None}
    if set(att["stages"]) != want or (
            att["wire"]["total_bytes"] != ledger.wire["total_bytes"]):
        bad.append("attribution")
    mar = js(["margins", "p18_obs"])["p18_obs"]
    if _json.loads(_json.dumps(margin_series(events), default=float)) != mar:
        bad.append("margins")
    num = js(["numerics", "p18_obs"])["p18_obs"]
    want_num = _json.loads(_json.dumps(
        {k: [list(x) for x in v] for k, v in
         numerics_series(events).items()}, default=float))
    if want_num != num:
        bad.append("numerics")
    out = os.path.join(run_dir, "p18_obs.trace.json")
    run(["trace", "p18_obs", "-o", out])
    with open(out) as f:
        if validate_trace(_json.load(f)):
            bad.append("trace")
    if run(["selfcheck"])[-1] != ("ok   selfcheck: index refresh "
                                  "idempotent, all entries resolvable"):
        bad.append("selfcheck")
    rc, lines = p18_reader(report.main, [manifests["p18_obs"]["events"],
                                         "--json"])
    rep = _json.loads(lines[-1])[manifests["p18_obs"]["events"]]
    if rc != 0 or rep["accuracy"]["final"] != round(
            manifests["p18_obs"]["final_accuracy"], 2):
        bad.append("report")
    if bad:
        failures.append(f"campaign (d) readers: {bad}")
    print(f"[campaign] (d) readers over {summary['entries']} runs: refresh "
          f"{1e3 * warm_s:.1f} ms over the stamped index, "
          f"{1e3 * refresh_s:.1f} ms from nothing (built "
          f"{summary['built']}), list, show,"
          f" diff, compare, campaign, forensics, async, traffic, walls "
          f"({len(names)} entry points), attribution, margins, numerics, "
          f"trace, selfcheck, report: "
          f"{'held' if not bad else bad}", flush=True)


def run_campaign_path(ds, failures, smi):
    """Phase 18: campaigns and the run readers on the card.  (a) the
    campaign of P18_DEFENSES x (ALIE, none) and P18_EXTRA through the
    inline executor into a store of its own, each cell byte-equal to its
    direct twin (phase 5's runs, else one run here), its must and
    must-not launches, the allocator back at rest after each cell, the
    library loads all hits on a warm build directory; (b) three cells
    under the supervisor, one preempted, byte-equal to their inline twins;
    (c) a campaign process SIGKILLed after two commits and invoked again;
    (d) the readers over (a)'s store; (e) grid.py over the five defenses
    under ALIE.  Returns launches per kernel summed over the inline runs
    (campaign, twins, grid)."""
    import tempfile

    import torch

    from attacking_federate_learning_tpu_torch.campaigns import CampaignSpec
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig
    )
    from attacking_federate_learning_tpu_torch.grid import run_grid
    from attacking_federate_learning_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    totals = {name: 0 for name in _build.LAUNCHES}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_p18_") as root:
        spec = CampaignSpec(
            name="p18", base=p18_base(os.path.join(root, "a")),
            axes={"defense": list(P18_DEFENSES), "attack": ["alie", "none"]},
            cells=[dict(c) for c in P18_EXTRA], order="spec")
        # -- (a) ---------------------------------------------------------
        launches, recs, rows, camp, rest, wall, books = p18_inline(
            spec, failures)
        cache = os.path.join(root, "a", "build")     # p18_inline's copy
        add(launches)
        man = camp.journal.read_manifest()
        cells = spec.expand()
        skipped = [c for c in cells if c.skip]
        if (len(skipped) != 1 or "4*corrupted_count" not in skipped[0].skip
                or man["counts"] != {"done": len(cells) - 1,
                                     "skipped": 1}):
            failures.append(f"campaign (a): counts {man['counts']}, skips "
                            f"{[c.skip for c in skipped]}")
        prev = t_phase
        for cell in cells:
            row = rows.get(cell.cell_id, {})
            if cell.skip:
                print(f"[campaign] (a) {cell.overrides['defense']} f=25 "
                      f"skipped: {row.get('reason')}", flush=True)
                continue
            kind = p18_kind(cell)
            rec = recs[cell.cell_id]
            twin = P5_FINAL.get((cell.cfg.defense, cell.cfg.faults
                                 is not None, cell.cfg.mal_prop))
            source, direct = "phase5", ""
            if (twin is None or cell.attack != "alie"
                    or cell.cfg.aggregation != "flat"):
                twin, tw_launch, tw_s = p18_direct(ds, cell)
                add(tw_launch)
                source = "direct"
                direct = (f"direct_run_s={tw_s:.3f} (rounds/s "
                          f"{cell.cfg.epochs / tw_s:.2f}) ")
            same = torch.equal(rec["weights"], twin)
            must = P18_MUST[kind]
            ran = {k for k, v in rec["launches"].items() if v}
            libs = p18_libraries(ran)
            cache_ok = (row.get("cache_hits") == len(libs)
                        and row.get("cache_misses") == 0)
            mem_ok = row.get("allocated", 0) <= rest + P18_MEM_SLACK
            # The libraries came from (a)'s build directory, set while
            # the cell ran.
            dir_ok = (rec["build_dir"] == cache
                      and rec["loaded_from"] <= {cache})
            ok = (same and row.get("state") == "done" and ran == set(must)
                  and cache_ok and mem_ok and dir_ok)
            if not ok:
                failures.append(
                    f"campaign (a) {kind} {cell.attack}: byte_equal={same} "
                    f"({source}) launched {sorted(ran)} (must be "
                    f"{sorted(must)}), cache {row.get('cache_hits')}/"
                    f"{row.get('cache_misses')} for {sorted(libs)} from "
                    f"{sorted(rec['loaded_from'])} with {rec['build_dir']} "
                    f"set (want {cache}), allocated {row.get('allocated')} "
                    f"(rest {rest})")
            overhead = row.get("committed", prev) - prev - rec["run_s"]
            prev = row.get("committed", prev)
            man_cell = os.path.join(camp.run_dir, cell.cell_id,
                                    "manifest.json")
            with open(man_cell) as f:
                rps = json.load(f).get("rounds_per_s")
            ran_counts = {k: v for k, v in rec["launches"].items() if v}
            print(f"[campaign] (a) {kind:20s} {cell.attack:4s} f="
                  f"{cell.cfg.corrupted_count:<3d} "
                  f"acc={row.get('final_accuracy')} "
                  f"wall_s={row.get('wall_s')} rounds_per_s={rps} "
                  f"run_s={rec['run_s']:.3f} (rounds/s "
                  f"{cell.cfg.epochs / rec['run_s']:.2f}) {direct}"
                  f"campaign_overhead_s={overhead:.3f} "
                  f"launches={ran_counts} "
                  f"cache_hits={row.get('cache_hits')} cache_misses="
                  f"{row.get('cache_misses')} allocated_after_MB="
                  f"{row.get('allocated', 0) / 1e6:.3f} (rest "
                  f"{rest / 1e6:.3f}) peak_GB={rec['peak'] / 1e9:.3f} "
                  f"libraries_from_build_copy={dir_ok} "
                  f"byte_equal_{source}_twin={same} on {smi}", flush=True)
        commit_ms = sorted(1e3 * x for x in books["commit_s"])
        print(f"[campaign] (a) {len(cells)} cells in {wall:.1f} s "
              f"(manifest cache {man['cache']['hits']} hit / "
              f"{man['cache']['misses']} miss over "
              f"{man['cache']['bytes'] / 1e6:.1f} MB); the campaign's own "
              f"work: plan {1e3 * books['plan_s']:.1f} ms, a commit "
              f"(journal, event, manifest) median "
              f"{statistics.median(commit_ms):.2f} ms, max "
              f"{commit_ms[-1]:.2f} ms", flush=True)
        # -- (b), and (c) beside it: each of their processes spends most
        # of its life starting (torch's import), so the two overlap.  A
        # fresh process's start-up is timed alone first.
        import threading

        steps = p18_startup()
        steps_txt = {k: round(v, 3) for k, v in steps.items()
                     if k != "error"}
        print(f"[campaign] (b) a fresh process's start-up alone, s: "
              f"{steps_txt} {steps.get('error', '')}", flush=True)
        kill = threading.Thread(target=p18_kill, args=(root, failures))
        kill.start()
        old_path = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = ROOT
        try:
            p18_supervised(spec, recs, failures, smi)
        finally:
            if old_path is None:
                del os.environ["PYTHONPATH"]
            else:
                os.environ["PYTHONPATH"] = old_path
        kill.join()
        # -- (d) ---------------------------------------------------------
        obs = p18_observed(ds, os.path.join(root, "a"), failures)
        add(obs[3])
        p18_readers(camp, obs, failures)
        del obs, recs
        gc.collect()
        torch.cuda.empty_cache()
        # -- (e) ---------------------------------------------------------
        base = ExperimentConfig(**p18_base(os.path.join(root, "e")))
        _build.reset_launches()
        t0 = time.perf_counter()
        grid_rows = run_grid(base, list(P18_DEFENSES), ["alie"],
                             out_path=os.path.join(root, "grid.jsonl"),
                             device="cuda")
        grid_s = time.perf_counter() - t0
        add(dict(_build.LAUNCHES))
        want = {(c.cfg.defense, "alie"): rows[c.cell_id]["final_accuracy"]
                for c in cells if not c.skip and c.attack == "alie"
                and p18_kind(c) in P18_DEFENSES}
        got = {(r["defense"], r["attack"]): r.get("final_accuracy")
               for r in grid_rows}
        if got != want or len(grid_rows) != len(P18_DEFENSES):
            failures.append(f"campaign (e) grid: {got} vs the campaign's "
                            f"{want}")
        print(f"[campaign] (e) grid.py, the five defenses x alie in "
              f"{grid_s:.1f} s: final accuracies {got}, the campaign's "
              f"cells' {'equal' if got == want else want}", flush=True)
    print(f"[campaign] phase 18 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from attacking_federate_learning_tpu_torch.ops import _build

    # -- 1. device ----------------------------------------------------------
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(kind)
    print(f"[device] {smi}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{kind}; peaks for the {part} part: "
          f"{peaks[0] / 1e12:.1f} TFLOP/s fp32, {peaks[1] / 1e12:.2f} TB/s, "
          f"{peaks[2] / 1e12:.0f} TFLOP/s dense bf16", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    times = _build.build_all()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in times.items()})}"
          f" wall {time.perf_counter() - t0:.1f} s", flush=True)
    failures = []
    sort_route_build(failures)
    gram_route_build(failures)
    # -- 3. kernels vs plain ----------------------------------------------
    entries = check_kernels(peaks, failures)
    # -- 4. small-input reference ------------------------------------------
    check_reference(failures)
    # -- 5. main path --------------------------------------------------------
    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )

    t0 = time.perf_counter()
    ds = load_dataset(C.SYNTH_MNIST, seed=0, synth_train=60_000,
                      synth_test=10_000)
    print(f"[main] SYNTH_MNIST 60000/10000 made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    totals, clean_ms = run_main_path(ds, failures)
    # -- 6. attack layer -----------------------------------------------------
    attack_totals = run_attack_path(ds, failures)
    # -- 7. the model family -------------------------------------------------
    model_totals = run_model_path(ds, failures)
    # -- 8. the round's knobs ------------------------------------------------
    knob_totals = run_knobs_path(ds, failures)
    # -- 9. the run lifecycle ------------------------------------------------
    life_totals = run_lifecycle_path(ds, failures, smi, clean_ms["Krum"])
    # -- 10. asynchronous buffered rounds ------------------------------------
    async_totals = run_async_path(ds, failures, smi)
    # -- 11. the beyond-reference defenses ------------------------------------
    entries["threefry_bits"] = check_threefry_kernel(peaks, failures)
    defense_totals = run_defense_path(ds, failures, smi)
    # -- 12. population & traffic ---------------------------------------------
    traffic_totals = run_traffic_path(ds, failures, smi)
    # -- 13. the hierarchical round -------------------------------------------
    hier_totals = run_hier_path(ds, failures, smi)
    # -- 14. secure aggregation ----------------------------------------------
    secagg_entries, secagg_totals = run_secagg_path(ds, failures, smi)
    entries.update(secagg_entries)
    # -- 15. the observatories ------------------------------------------------
    observe_totals = run_observe_path(ds, failures, smi)
    # -- 16. the walls and the cost ledger -------------------------------------
    walls_totals = run_walls_path(ds, failures, smi)
    # -- 17. the host engines and host streaming --------------------------------
    host_totals = run_hostpath(ds, failures, smi)
    # -- 18. campaigns and the run readers ------------------------------------
    campaign_totals = run_campaign_path(ds, failures, smi)
    for name, e in entries.items():
        e["launches"] = sum(t[name] for t in (
            totals, attack_totals, model_totals, knob_totals, life_totals,
            async_totals, defense_totals, traffic_totals, hier_totals,
            secagg_totals, observe_totals, walls_totals, host_totals,
            campaign_totals))

    if failures:
        for msg in failures:
            print(f"FAILED: {msg}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
