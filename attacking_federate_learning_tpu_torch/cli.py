"""Experiment CLI of the flat FedSGD round, the async buffered round and
the hierarchical two-tier round.

The flat flags of the JAX package's CLI, with the reference driver's
short flags and defaults (-m 0.24, -z 1.5, -d NoDefense, -s MNIST, -b No,
-e 300), ``--attack`` / ``--attack-direction``, ``--model`` and
``--augment``, the ``--fault-*`` flags of the fault model, the round's
knobs (``--participation``, ``--local-steps``, ``--partition`` with
``--dirichlet-alpha`` and ``--style-strength``, ``--krum-scoring-method``,
``--krum-paper-scoring``, ``--bulyan-batch-select``, ``--distance-dtype``,
``--server-uses-faded-lr``, ``--remat``: the client step recomputes its
activations in the backward, per residual block on the ResNets and the
whole forward on the other models), the
engine knobs (``--distance-impl``, ``--bulyan-selection-impl``,
``--aggregation-impl``, ``--bulyan-trim-impl``, ``--trimmed-mean-impl``,
``--median-impl``: 'host' names a host engine, every other value the
card's kernels) and host streaming (``--data-placement``,
``--stream-prefetch``, ``--stream-workers``), the device mesh's
``--mesh-shape c,m`` (c x m positions over every visible card: a flat
round's cohort and a hierarchical round's megabatches dealt out over
the clients axis, the gradients' columns and the server state over the
model axis where m divides d), the
async buffered round's (``--aggregation``, ``--async-buffer``,
``--async-max-staleness``, ``--staleness-weight``), the hierarchical
round's (``--megabatch``, ``--tier2-defense``, ``--mal-placement``,
``--tier1-corrupted``, ``--tier2-corrupted``), secure aggregation's
``--secagg`` (vanilla on the flat round, groupwise on the hierarchical
one), the beyond-reference defenses'
(``-d`` DnC/GeoMedian/CenteredClip/FLTrust/NormBound with
``--dnc-iters``, ``--dnc-sketch-dim``, ``--dnc-filter-frac``,
``--geomed-iters``, ``--geomed-eps``, ``--cclip-tau``, ``--cclip-iters``),
the twelve ``--traffic-*`` flags of the population & traffic engine,
the run lifecycle's (``-o``,
``--log-dir``, ``--run-dir``, ``--no-checkpoint``, ``--resume``,
``--checkpoint-every``, ``--heartbeat``, ``--journal``, ``--run-id``),
the observatories' (``--round-stats``, ``--telemetry``, ``--margins``,
``--numerics``, ``--profile``, ``--trace-dir``, ``--profile-every``,
``--cost-report``; with the last two, the run ends with
measured-vs-modeled ``[walls]`` lines, stage by stage),
plus ``--device``.  As in the JAX package, ``grad_dtype`` and
``collect_metadata`` are config fields with no flag.
It prints the same ``Test set: [ N] ... Accuracy: x/N`` lines, and
under a backdoor (``-b``) the ``BEFORE:`` line and a ``##Test malicious
net: [POST]`` line after each evaluation.
The run is on the card unless ``--device cpu`` asks for the CPU.

The run writes the JAX package's artifacts: the accuracy CSV and the
schema-v14 event log under ``--log-dir``, checkpoints under
``--run-dir``, and with ``--journal`` the exactly-once journal and
manifest under ``<run-dir>/<run-id>/``.  SIGTERM or SIGINT, or the
``FL_PREEMPT_AT_ROUND=k`` injection, checkpoints at the next host
boundary and exits 75; ``--resume`` continues from the newest
checkpoint.  A divergence past the watchdog's rollbacks exits 76.
``--attack backdoor_timed`` needs ``--aggregation async``, as in the JAX
package; ``--krum-scoring-method`` other than 'sort' is refused (the JAX
package's XLA-suite evaluators, which the port's Pallas suite never
reaches).

Run:  python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Krum -n 100 -m 0.24
      FL_PREEMPT_AT_ROUND=8 python -m attacking_federate_learning_tpu_torch.cli \\
          -s SYNTH_MNIST -n 100 -e 21 --journal --run-id r1 \\
          --checkpoint-every 5                      # exits 75 at round 10
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -n 100 -e 21 --journal --run-id r1 --checkpoint-every 5 --resume
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Krum -n 100 -m 0.24 -b pattern
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d TrimmedMean -n 100 -m 0.24 --attack minmax
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Median -n 100 -m 0.1 --fault-dropout 0.1 --fault-straggler 0.1
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d TrimmedMean -n 100 -m 0.24 --aggregation async \\
          --async-buffer 64 --staleness-weight poly
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Krum -n 1000 -m 0.24 --aggregation hierarchical \\
          --megabatch 100 --tier2-defense Median
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d NoDefense -n 100 -m 0.24 --secagg vanilla --fault-dropout 0.1
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d NoDefense -n 1000 -m 0.24 --aggregation hierarchical \\
          --megabatch 100 --tier2-defense Krum --secagg groupwise
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d DnC -n 100 -m 0.24 --attack minmax
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Krum -n 100 -m 0.24 --traffic-population 100000 \\
          --traffic-diurnal-amp 0.5
      python -m attacking_federate_learning_tpu_torch.cli \\
          -s SYNTH_CIFAR10_HARD -d TrimmedMean -n 100 -m 0.24 \\
          --synth-train 50000 --synth-test 10000
      python -m attacking_federate_learning_tpu_torch.cli -s CIFAR100 \\
          -d Krum -n 10 -m 0.2 --synth-train 50000 --synth-test 10000
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Krum -n 100 -m 0.24 --profile-every 2 --cost-report --profile

The JAX package's subcommands are dispatched before argparse, so the
experiment flag surface stays as it is: ``report`` (report.py, the run
report over event logs), ``campaign`` (campaigns/cli.py, a declarative
sweep as resumable cells, on the card unless ``--device cpu``) and
``runs`` (runs_cli.py, the fifteen verbs over the run registry, ``runs
trace`` among them: a run's event log as a Chrome trace):

      python -m attacking_federate_learning_tpu_torch.cli report logs/r.jsonl
      python -m attacking_federate_learning_tpu_torch.cli campaign spec.json
      python -m attacking_federate_learning_tpu_torch.cli runs list
      python -m attacking_federate_learning_tpu_torch.cli runs trace RUN_ID
"""

from __future__ import annotations

import argparse
import os
import sys

from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import ExperimentConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Federated-learning attack/defense simulator "
                    "(PyTorch/CUDA port, flat FedSGD round)")
    p.add_argument("-s", "--dataset", default=C.MNIST, choices=C.DATASETS,
                   help="CIFAR100 runs the WRN-40-4 the reference defines "
                        "but never exposes (reference main.py:114 excludes "
                        "it; data_sets.py:108-173 defines it); without the "
                        "raw files in --data-dir, MNIST, CIFAR10 and "
                        "CIFAR100 fall back to synthetic sets of their "
                        "shape")
    p.add_argument("--model", default=None, choices=C.MODEL_NAMES,
                   help="override the dataset's canonical model "
                        "(default: MLP for MNIST, CNN for CIFAR10, "
                        "WRN-40-4 for CIFAR100)")
    p.add_argument("-d", "--defense", default="NoDefense",
                   choices=list(C.DEFENSE_NAMES))
    p.add_argument("--attack", default="auto",
                   choices=["auto", "none", "alie", "backdoor",
                            "backdoor_timed", "signflip", "noise",
                            "minmax", "minsum"],
                   help="'auto' = reference behavior (backdoor if -b set, "
                        "else ALIE, reference main.py:44-54); the rest are "
                        "beyond-reference baselines (attacks/); "
                        "'backdoor_timed' is the async timing-channel "
                        "variant (emits with delay 0 so its rows always "
                        "arrive fresh; needs --aggregation async)")
    p.add_argument("--attack-direction", default="std",
                   choices=["std", "sign", "unit"],
                   help="min-max/min-sum perturbation direction "
                        "(attacks/minmax.py): cohort -std (the NDSS'21 "
                        "paper's best), -sign(mean), or -unit mean")
    p.add_argument("--dnc-iters", default=ExperimentConfig.dnc_iters,
                   type=int, help="DnC filtering iterations")
    p.add_argument("--dnc-sketch-dim",
                   default=ExperimentConfig.dnc_sketch_dim, type=int,
                   help="DnC coordinate-sketch size per iteration")
    p.add_argument("--dnc-filter-frac",
                   default=ExperimentConfig.dnc_filter_frac, type=float,
                   help="DnC outliers removed per iteration, as a "
                        "fraction of f")
    p.add_argument("--geomed-iters", default=ExperimentConfig.geomed_iters,
                   type=int, help="GeoMedian Weiszfeld iterations")
    p.add_argument("--geomed-eps", default=ExperimentConfig.geomed_eps,
                   type=float,
                   help="GeoMedian distance-smoothing floor")
    p.add_argument("--cclip-tau", default=ExperimentConfig.cclip_tau,
                   type=float,
                   help="CenteredClip L2 clip radius (ICML'21)")
    p.add_argument("--cclip-iters", default=ExperimentConfig.cclip_iters,
                   type=int, help="CenteredClip re-centering trips")
    p.add_argument("--trimmed-mean-impl",
                   default=ExperimentConfig.trimmed_mean_impl,
                   choices=["xla", "host"],
                   help="TrimmedMean kernel: traced XLA (default) or the "
                        "opt-in native host kernel (fast at 10k clients "
                        "on the CPU backend)")
    p.add_argument("--median-impl",
                   default=ExperimentConfig.median_impl,
                   choices=["xla", "host"],
                   help="Median kernel: traced XLA (default) or the "
                        "opt-in native host kernel")
    p.add_argument("-n", "-dispatch_weightsn", "--users-count", default=10,
                   type=int)
    p.add_argument("-m", "--mal-prop", default=0.24, type=float,
                   help="proportion of malicious users")
    p.add_argument("-z", "--num_std", default=1.5,
                   type=lambda s: s if s == "auto" else float(s),
                   help="how many standard deviations the ALIE attacker "
                        "shifts; 'auto' computes the ALIE paper's z_max "
                        "from (n, f)")
    p.add_argument("-e", "--epochs", default=300, type=int)
    p.add_argument("--participation", default=1.0, type=float,
                   help="fraction of clients sampled each round (static "
                        "cohort sizes, random identities; 1.0 = the "
                        "reference's everyone-every-round)")
    p.add_argument("--local-steps", default=1, type=int,
                   help="FedAvg-style local SGD steps per round (1 = the "
                        "reference's FedSGD; k>1 reports (w0-w_k)/lr as "
                        "the wire gradient)")
    p.add_argument("--partition", default="iid",
                   choices=["iid", "dirichlet", "femnist_style"])
    p.add_argument("--dirichlet-alpha", default=0.5, type=float)
    p.add_argument("--style-strength", default=0.25, type=float,
                   help="femnist_style per-client contrast/brightness "
                        "spread (data/partition.py client_style_params)")
    p.add_argument("--krum-scoring-method", default="sort",
                   choices=["sort", "topk", "auto"],
                   help="Krum/Bulyan score evaluation: cancellation-free "
                        "'sort' (default), complement-'topk' (cheaper at "
                        "large n / small f; a runtime guard falls back to "
                        "sort when the subtraction would cancel), or "
                        "'auto' to pick by shape")
    p.add_argument("--bulyan-batch-select",
                   default=ExperimentConfig.bulyan_batch_select, type=int,
                   help="Bulyan selection batch size: q>1 selects the q "
                        "lowest-scoring clients per trip against the same "
                        "scores (a flagged relaxation of the reference's "
                        "sequential selection for the 10k regime); 1 = "
                        "reference-exact")
    p.add_argument("--bulyan-selection-impl",
                   default=ExperimentConfig.bulyan_selection_impl,
                   choices=["xla", "host", "pallas"],
                   help="Bulyan selection engine: traced XLA loop "
                        "(default), the hybrid exact path — device "
                        "distances, one (n, n) host marshal, native "
                        "incremental selection, device trim-mean — or "
                        "'pallas': the same exact loop over the fused "
                        "pallas distance kernel's on-device D (no "
                        "marshal at all; ops/pallas_defense.py)")
    p.add_argument("--aggregation-impl",
                   default=ExperimentConfig.aggregation_impl,
                   choices=["xla", "pallas"],
                   help="Defense-kernel suite (ops/pallas_defense.py): "
                        "'pallas' runs the tier-1 pipeline on-device — "
                        "fused distance->Krum-score kernel, tiled "
                        "trimmed-mean/median, all-on-device Bulyan — "
                        "with interpret-mode fallback off-TPU; 'xla' "
                        "(default) leaves every path unchanged")
    p.add_argument("--bulyan-trim-impl",
                   default=ExperimentConfig.bulyan_trim_impl,
                   choices=["xla", "host"],
                   help="Bulyan trimmed-mean tail: traced XLA kernel "
                        "(default) or the native host kernel (the "
                        "CPU-backend 10k opt-in; same standard as "
                        "--trimmed-mean-impl)")
    p.add_argument("--distance-impl", default="auto",
                   choices=["auto", "xla", "pallas", "host", "ring",
                            "allgather"],
                   help="Krum/Bulyan distance engine (defenses/kernels.py): "
                        "XLA Gram matmul, fused pallas TPU kernel, host "
                        "BLAS (CPU backend), or the blockwise shard_map "
                        "schedules over the clients mesh axis "
                        "(ring/allgather need --mesh-shape)")
    p.add_argument("--distance-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype for the Krum/Bulyan distance computation "
                        "only (training stays f32): bfloat16 rides the "
                        "MXU at native throughput with f32 accumulation "
                        "— a flagged deviation for the 10k regime")
    p.add_argument("--aggregation", default="flat",
                   choices=["flat", "hierarchical", "async"],
                   help="'flat' = reference path (one (n, d) matrix, one "
                        "defense call); 'hierarchical' streams the client "
                        "axis through --megabatch-sized scan shards with "
                        "per-shard tier-1 robust estimates and a tier-2 "
                        "cross-shard reduction — the (n, d)/(n, n) arrays "
                        "never materialize (ops/federated.py); 'async' = "
                        "FedBuff-style buffered rounds — updates arrive "
                        "PRNG-drawn rounds late, the server aggregates "
                        "the first --async-buffer pending arrivals with "
                        "staleness-weighted contributions "
                        "(core/async_rounds.py)")
    p.add_argument("--async-buffer", default=0, type=int, metavar="K",
                   help="async mode's FedBuff buffer size: pending "
                        "updates consumed per round, FIFO (required "
                        ">= 1 under --aggregation async)")
    p.add_argument("--async-max-staleness",
                   default=ExperimentConfig.async_max_staleness,
                   type=int, metavar="S",
                   help="async staleness bound: arrival delays draw "
                        "from [0, S], a pending update older than S "
                        "rounds is evicted (masked, never aggregated)")
    p.add_argument("--staleness-weight", default="none",
                   choices=["none", "poly", "const"],
                   help="async contribution discount by staleness s: "
                        "'none' (pure first-k), 'poly' (1/sqrt(1+s), "
                        "the FedBuff paper), 'const' (0.5 for any "
                        "stale row) — threaded into the mask-aware "
                        "kernels' weights= seam")
    p.add_argument("--megabatch", default=0, type=int, metavar="M",
                   help="hierarchical tier-1 shard size m (must divide "
                        "--users-count, >= 2 shards); round peak memory "
                        "scales with m*d instead of n*d")
    p.add_argument("--tier2-defense", default=None,
                   choices=["NoDefense", "Krum", "TrimmedMean", "Bulyan",
                            "Median"],
                   help="tier-2 reducer over the (n/m, d) shard-estimate "
                        "matrix (defenses/kernels.py shard_* entries); "
                        "default: same family as -d/--defense")
    p.add_argument("--mal-placement", default="spread",
                   choices=["spread", "concentrated"],
                   help="colluder placement across megabatches: 'spread' "
                        "deals the malicious ids round-robin, "
                        "'concentrated' packs them into the fewest shards "
                        "(the colluders-own-a-shard scenario; only "
                        "meaningful under --aggregation hierarchical)")
    p.add_argument("--tier1-corrupted", default=None, type=int,
                   metavar="F1",
                   help="assumed per-shard corrupted bound for tier-1 "
                        "(default: ceil(f / num_shards), the spread "
                        "worst case)")
    p.add_argument("--tier2-corrupted", default=None, type=int,
                   metavar="F2",
                   help="assumed corrupted-shard bound for tier-2 "
                        "(default: ceil(f / megabatch))")
    p.add_argument("--secagg", default="off",
                   choices=["off", "vanilla", "groupwise"],
                   help="secure-aggregation protocol layer "
                        "(protocols/secagg.py): 'vanilla' = Bonawitz-"
                        "style pairwise-masked cohort sum (requires -d "
                        "NoDefense — the server sees no per-client "
                        "rows; --fault-dropout becomes a mask-"
                        "reconstruction round), 'groupwise' = NET-SA-"
                        "style per-megabatch sums composed with "
                        "--aggregation hierarchical (tier-2 robust "
                        "kernels run over group sums via "
                        "--tier2-defense)")
    p.add_argument("--profile", action="store_true",
                   help="accumulate per-phase (round/eval) wall-clock, "
                        "synchronised with the card, and record it in "
                        "the JSONL log ('profile' event; a phase_timing "
                        "line at the end)")
    p.add_argument("--trace-dir", type=str, default=None,
                   help="capture the whole run with torch.profiler into "
                        "this dir (a Chrome trace: open it in Perfetto); "
                        "with --profile-every it pauses while an interval "
                        "is captured and goes on in a new file")
    p.add_argument("--profile-every", default=0, type=int, metavar="K",
                   help="measured-walls observatory (utils/walls.py): "
                        "time every eval interval and evaluation on the "
                        "host clock and capture + stage-book one "
                        "profiler trace per K eval intervals "
                        "(<log-dir>/walltrace/r<epoch>), recorded as "
                        "schema-v10 'wall' events; 0 disables")
    p.add_argument("--cost-report", action="store_true",
                   help="before training, run every entry point once on a "
                        "second engine under the counting mode and "
                        "record its FLOPs, bytes, per-stage split, hand "
                        "kernels' modeled counts and peak memory (the "
                        "card's allocator) as 'cost'/'stage_cost' "
                        "events, the kernel libraries' builds as "
                        "'compile' events and the wire ledger as one "
                        "'wire_bytes' event (utils/costs.py)")
    p.add_argument("--round-stats", action="store_true",
                   help="record per-round gradient/update norm diagnostics "
                        "in the JSONL log")
    p.add_argument("--telemetry", action="store_true",
                   help="per-round aggregation forensics: defense "
                        "selection masks/scores, trim/clip/trust "
                        "diagnostics, attack envelope stats, per-client "
                        "norms, written as 'defense'/'attack'/"
                        "'selection_hist' events.  Under --aggregation "
                        "hierarchical (and --secagg groupwise) the same "
                        "flag emits per-shard tier-1 + tier-2 "
                        "'shard_selection' events")
    p.add_argument("--margins", action="store_true",
                   help="robustness-margin observatory (utils/margins.py): "
                        "the defense's decision margins (Krum "
                        "winner/runner-up gap + per-row distance to the "
                        "selection threshold, trim boundary distances + "
                        "kept fractions, Bulyan selection slack) and the "
                        "attack's envelope utilization, rolled up into "
                        "one schema-v12 'margin' event per round.  "
                        "Requires a margin-bearing defense "
                        "(Krum/TrimmedMean/Median/Bulyan)")
    p.add_argument("--numerics", action="store_true",
                   help="numerics & determinism observatory "
                        "(utils/numerics.py): per-stage nonfinite counts, "
                        "gradient-norm dynamic range, distance-Gram "
                        "cancellation depth, and tie-proximity counters "
                        "banded at k ulp of the margin decision "
                        "boundaries, one schema-v14 'numerics' event per "
                        "round.  Works with any defense; the tie and "
                        "cancellation counters need a margin-bearing one")
    p.add_argument("--krum-paper-scoring", action="store_true",
                   help="paper-faithful Krum scoring (n-f-2 closest) instead "
                        "of the reference's n-f (defences.py:26)")
    p.add_argument("--server-uses-faded-lr", action="store_true",
                   help="paper-faithful mode: faded lr on the server step "
                        "(the reference uses the constant base lr, "
                        "server.py:89)")
    p.add_argument("-b", "--backdoor", default="No",
                   choices=["No", "pattern", "1", "2", "3"],
                   help="no backdoor, pattern trigger, or single-sample "
                        "backdoor with the given training index")
    p.add_argument("-c", "--batch-size", "--batch_size", dest="batch_size",
                   default=128, type=int)
    p.add_argument("-l", "--learning_rate", default=0.1, type=float)
    p.add_argument("-o", "--output", type=str,
                   help="output file for results (tee)")
    p.add_argument("--synth-train", default=ExperimentConfig.synth_train,
                   type=int,
                   help="training examples for SYNTH_* / fallback datasets")
    p.add_argument("--synth-test", default=ExperimentConfig.synth_test,
                   type=int,
                   help="test examples for SYNTH_* / fallback datasets")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--test-step", default=ExperimentConfig.test_step,
                   type=int, help="evaluate every this many rounds")
    p.add_argument("--data-dir", default="data", type=str)
    p.add_argument("--log-dir", default="logs", type=str,
                   help="CSV/JSONL output dir (reference logs/, main.py:100)")
    p.add_argument("--run-dir", default="runs", type=str,
                   help="checkpoint dir (reference runs/, server.py:44)")
    # JAX's help text, kept word for word (the port's recompute is
    # models/remat.py).
    p.add_argument("--remat", action="store_true",
                   help="rematerialize client activations in the backward "
                        "pass (jax.checkpoint) — trades FLOPs for HBM at "
                        "WRN/large-cohort scale")
    p.add_argument("--data-placement", default="device",
                   choices=["device", "host_stream"],
                   help="'device' holds the training set in HBM; "
                        "'host_stream' keeps it in host RAM and "
                        "double-buffers per-round batches (beyond-HBM "
                        "datasets)")
    p.add_argument("--stream-prefetch",
                   default=ExperimentConfig.stream_prefetch, type=int,
                   help="host_stream pipeline depth: rounds of batches "
                        "kept in flight (data/stream.py)")
    p.add_argument("--stream-workers",
                   default=ExperimentConfig.stream_workers, type=int,
                   choices=[0, 1],
                   help="1 = run the host gather + transfer on a "
                        "background thread so it overlaps device compute")
    p.add_argument("--mesh-shape", default=None, type=str,
                   help="'clients,model' device split, e.g. 8,1; "
                        "'none' clears an earlier --mesh-shape (argparse "
                        "last-wins — the supervisor's OOM degradation "
                        "appends it to relax the MeshPlan).  Under "
                        "--aggregation hierarchical a clients axis > 1 "
                        "runs tier-1 as one SPMD shard_map program "
                        "(each device scans its own megabatches; "
                        "n/megabatch must divide the clients axis)")
    p.add_argument("--no-checkpoint", action="store_true",
                   help="disable the acc>70%% checkpoint (reference "
                        "main.py:84-89 behavior is on by default)")
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   metavar="CKPT",
                   help="resume from a checkpoint (.npz path, or no value "
                        "to use the newest checkpoint in runs/<dataset>/ — "
                        "auto-checkpoints included); continues from the "
                        "saved round, fault state included")
    p.add_argument("--checkpoint-every", default=0, type=int,
                   metavar="N",
                   help="write a rotated, atomically-replaced auto-"
                        "checkpoint every N rounds (0 = off) — the "
                        "--resume target after a kill and the rollback "
                        "target for the fault watchdog")
    p.add_argument("--fault-dropout", default=0.0, type=float,
                   metavar="P",
                   help="per-client per-round dropout probability: the "
                        "client returns no update; its row is "
                        "quarantined out of the aggregation "
                        "(core/faults.py)")
    p.add_argument("--fault-straggler", default=0.0, type=float,
                   metavar="P",
                   help="per-client per-round straggler probability: the "
                        "client submits its gradient from "
                        "--fault-straggler-delay rounds ago (stale ring "
                        "buffer on the device)")
    p.add_argument("--fault-straggler-delay", default=1, type=int,
                   metavar="K", help="straggler staleness in rounds")
    p.add_argument("--fault-corrupt", default=0.0, type=float,
                   metavar="P",
                   help="per-HONEST-client per-round corruption "
                        "probability (distinct from the attack seam, "
                        "which owns rows [0, f)); see "
                        "--fault-corrupt-mode")
    p.add_argument("--fault-corrupt-mode", default="nan",
                   choices=["nan", "inf", "scale"],
                   help="corruption flavor: non-finite rows ('nan'/'inf' "
                        "— caught by the pre-aggregation quarantine) or "
                        "finite bit-scaled rows ('scale' — what the "
                        "robust defense / divergence watchdog must "
                        "absorb)")
    p.add_argument("--fault-shard-dropout", default=0.0, type=float,
                   metavar="P",
                   help="per-SHARD-DOMAIN per-round failure onset "
                        "probability (hierarchical only): a dead domain "
                        "loses its whole megabatch for "
                        "--fault-shard-dropout-dwell rounds, its tier-1 "
                        "estimate is excluded at tier-2 (alive_counts "
                        "seam) and the host-planned remask -> fallback "
                        "-> hold ladder degrades the tier-2 kernel when "
                        "too few shards survive (core/faults.py)")
    p.add_argument("--fault-shard-dropout-dwell", default=1, type=int,
                   metavar="K",
                   help="rounds a dead shard domain stays dead after "
                        "each failure onset (correlated outage width)")
    p.add_argument("--traffic-population", default=0, type=int,
                   metavar="P",
                   help="population & traffic engine (core/population.py): "
                        "sample each round's cohort from a registry of P "
                        "clients (P >> cohort; per-client state is lazy — "
                        "no (P,)-sized tensor ever exists) with diurnal "
                        "arrival, correlated on/off churn, heavy-tail "
                        "async latencies, and a defense-validity watchdog "
                        "that degrades under-filled rounds through "
                        "remask -> fallback defense -> hold, each "
                        "decision a v11 'traffic' event; 0 = off (the "
                        "legacy --participation draw)")
    p.add_argument("--traffic-rate", default=0.9, type=float, metavar="R",
                   help="base per-round arrival rate (scaled per client "
                        "by its reliability profile)")
    p.add_argument("--traffic-diurnal-amp", default=0.0, type=float,
                   metavar="A",
                   help="diurnal modulation amplitude in [0,1]: rate(t) = "
                        "R*(1 + A*sin(2*pi*t/period))")
    p.add_argument("--traffic-diurnal-period", default=24, type=int,
                   metavar="T", help="diurnal period in rounds")
    p.add_argument("--traffic-churn-dwell", default=4, type=int,
                   metavar="K",
                   help="mean on/off churn episode length in rounds "
                        "(per-client Markov-style alternating renewal: "
                        "one availability draw per K-round block)")
    p.add_argument("--traffic-latency-scale", default=1.0, type=float,
                   metavar="S",
                   help="heavy-tail straggler latency scale (async "
                        "engine: Pareto arrival delay replaces the "
                        "uniform 0..D draw)")
    p.add_argument("--traffic-latency-tail", default=1.5, type=float,
                   metavar="A", help="Pareto tail exponent (smaller = "
                                     "heavier straggler tail)")
    p.add_argument("--traffic-sybil-period", default=0, type=int,
                   metavar="T",
                   help="time-correlated colluder arrival: colluders "
                        "arrive only in a window of --traffic-sybil-width "
                        "rounds every T rounds, boosted so their AVERAGE "
                        "arrival mass matches uniform (fixed average f — "
                        "participation as an attack axis); 0 = uniform "
                        "colluder arrival")
    p.add_argument("--traffic-sybil-width", default=1, type=int,
                   metavar="W", help="sybil burst window width in rounds")
    p.add_argument("--traffic-fallback", default="Median",
                   choices=["Median", "TrimmedMean", "NoDefense"],
                   help="ladder step 2: the bounds-valid defense an "
                        "under-filled round falls back to when the "
                        "configured defense's validity bound breaks")
    p.add_argument("--traffic-min-cohort", default=1, type=int,
                   metavar="M",
                   help="floor on arrived clients below which the round "
                        "degrades regardless of defense bounds")
    p.add_argument("--traffic-seed", default=None, type=int,
                   metavar="SEED",
                   help="traffic schedule seed override (default: derived "
                        "from the experiment seed) — lets a campaign "
                        "sweep traffic realizations without moving the "
                        "data/init/attack draws")
    p.add_argument("--augment", default="auto",
                   choices=["auto", "on", "off"],
                   help="train-time reflect-pad-4 + random-crop + h-flip "
                        "(reference data_sets.py:157-166); 'auto' follows "
                        "the reference (CIFAR100 only)")
    p.add_argument("--heartbeat", default=0.0, type=float, metavar="SECS",
                   help="append a 'heartbeat' event every SECS seconds "
                        "(round, rounds/s EMA, rss, last-event age) so "
                        "a stalled run is distinguishable from a long "
                        "compile by tailing the events file; 0 = off")
    p.add_argument("--journal", action="store_true",
                   help="keep an append-only per-run journal + resume "
                        "manifest under runs/<run-id>/ "
                        "(utils/lifecycle.py): rounds and evals are "
                        "committed exactly once across any number of "
                        "restarts, and a resumed run never re-emits "
                        "events a previous attempt already recorded")
    p.add_argument("--run-id", default=None, metavar="ID",
                   help="journal identity override (implies --journal); "
                        "default derives from the config hash.  The "
                        "supervisor pins this so degraded restarts "
                        "(halved batch, CPU fallback) still share one "
                        "journal")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default), or the CPU with the kernels' "
                        "plain PyTorch versions")
    return p


def config_from_args(args) -> ExperimentConfig:
    mesh_shape = None
    if args.mesh_shape and args.mesh_shape.lower() != "none":
        mesh_shape = tuple(int(x) for x in args.mesh_shape.split(","))
    faults = None
    if (args.fault_dropout or args.fault_straggler or args.fault_corrupt
            or args.fault_shard_dropout):
        faults = C.FaultConfig(
            dropout=args.fault_dropout,
            straggler=args.fault_straggler,
            corrupt=args.fault_corrupt,
            straggler_delay=args.fault_straggler_delay,
            corrupt_mode=args.fault_corrupt_mode,
            shard_dropout=args.fault_shard_dropout,
            shard_dropout_dwell=args.fault_shard_dropout_dwell)
    traffic = None
    if args.traffic_population > 0:
        traffic = C.TrafficConfig(
            population=args.traffic_population,
            rate=args.traffic_rate,
            diurnal_amp=args.traffic_diurnal_amp,
            diurnal_period=args.traffic_diurnal_period,
            churn_dwell=args.traffic_churn_dwell,
            latency_scale=args.traffic_latency_scale,
            latency_tail=args.traffic_latency_tail,
            sybil_burst_period=args.traffic_sybil_period,
            sybil_burst_width=args.traffic_sybil_width,
            fallback_defense=args.traffic_fallback,
            min_cohort=args.traffic_min_cohort,
            seed=args.traffic_seed)
    return ExperimentConfig(
        users_count=args.users_count, mal_prop=args.mal_prop,
        dataset=args.dataset, model=args.model,
        learning_rate=args.learning_rate,
        batch_size=args.batch_size, epochs=args.epochs,
        local_steps=args.local_steps, participation=args.participation,
        partition=args.partition, dirichlet_alpha=args.dirichlet_alpha,
        style_strength=args.style_strength,
        krum_scoring_method=args.krum_scoring_method,
        krum_paper_scoring=args.krum_paper_scoring,
        distance_impl=args.distance_impl,
        distance_dtype=args.distance_dtype,
        bulyan_batch_select=args.bulyan_batch_select,
        bulyan_selection_impl=args.bulyan_selection_impl,
        bulyan_trim_impl=args.bulyan_trim_impl,
        aggregation_impl=args.aggregation_impl,
        trimmed_mean_impl=args.trimmed_mean_impl,
        median_impl=args.median_impl,
        data_placement=args.data_placement,
        stream_prefetch=args.stream_prefetch,
        stream_workers=args.stream_workers, mesh_shape=mesh_shape,
        server_uses_faded_lr=args.server_uses_faded_lr,
        num_std=args.num_std, defense=args.defense, test_step=args.test_step,
        data_dir=args.data_dir, seed=args.seed,
        synth_train=args.synth_train, synth_test=args.synth_test,
        backdoor=args.backdoor, attack_direction=args.attack_direction,
        dnc_iters=args.dnc_iters, dnc_sketch_dim=args.dnc_sketch_dim,
        dnc_filter_frac=args.dnc_filter_frac,
        geomed_iters=args.geomed_iters, geomed_eps=args.geomed_eps,
        cclip_tau=args.cclip_tau, cclip_iters=args.cclip_iters,
        data_augment={"auto": None, "on": True, "off": False}[args.augment],
        remat=args.remat, faults=faults, traffic=traffic,
        aggregation=args.aggregation,
        async_buffer=args.async_buffer,
        async_max_staleness=args.async_max_staleness,
        staleness_weight=args.staleness_weight,
        megabatch=args.megabatch, tier2_defense=args.tier2_defense,
        mal_placement=args.mal_placement,
        tier1_corrupted=args.tier1_corrupted,
        tier2_corrupted=args.tier2_corrupted, secagg=args.secagg,
        log_round_stats=args.round_stats, telemetry=args.telemetry,
        margins=args.margins, numerics=args.numerics,
        profile_every=args.profile_every,
        checkpoint_every=args.checkpoint_every, output=args.output,
        log_dir=args.log_dir, run_dir=args.run_dir)


def print_walls_vs_modeled(exp, ledger, print_fn) -> None:
    """Per entry point with both, its captures' device (or CPU) time by
    stage, summed, beside the counted FLOPs' stage shares
    (utils/walls.py:measured_vs_modeled)."""
    from attacking_federate_learning_tpu_torch.utils.walls import (
        measured_vs_modeled
    )

    costs = {r.name: r.stage_event() for r in ledger.records}
    sums = {}
    for rec in exp.wall_records:
        agg = sums.setdefault(rec.name, {"stages": {},
                                         "unattributed_us": 0.0})
        for st, us in rec.stages.items():
            agg["stages"][st] = agg["stages"].get(st, 0.0) + us
        agg["unattributed_us"] += rec.unattributed_us
    for name, agg in sums.items():
        if name not in costs:
            continue
        for stage, row in measured_vs_modeled(agg, costs[name]).items():
            print_fn(f"[walls] {name} {stage:16s} measured="
                     f"{row['measured_us'] / 1e3:.3f} ms "
                     f"share={row['measured_share']:.4f} "
                     f"modeled={row['modeled_share']} "
                     f"ratio={row['ratio']}")


def main(argv=None) -> dict:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "report":
        # Run-report subcommand (report.py): pure log reading.
        from attacking_federate_learning_tpu_torch.report import (
            main as report_main
        )

        raise SystemExit(report_main(argv[1:]))
    if argv and argv[0] == "campaign":
        # Campaign scheduler subcommand (campaigns/cli.py); heavy imports
        # stay lazy so --dry-run plans touch no tensor.
        from attacking_federate_learning_tpu_torch.campaigns.cli import (
            main as campaign_main
        )

        raise SystemExit(campaign_main(argv[1:]))
    if argv and argv[0] == "runs":
        # Cross-run registry subcommand (runs_cli.py): the fifteen verbs
        # over runs/index.jsonl (utils/registry.py).
        from attacking_federate_learning_tpu_torch.runs_cli import (
            main as runs_main
        )

        raise SystemExit(runs_main(argv[1:]))
    from attacking_federate_learning_tpu_torch.attacks import make_attacker
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment, resolve_device
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.utils.checkpoint import (
        Checkpointer, import_reference_checkpoint
    )
    from attacking_federate_learning_tpu_torch.utils.lifecycle import (
        EXIT_DIVERGED, EXIT_PREEMPTED, GracefulShutdown, Preempted,
        RunJournal, run_id_for
    )
    from attacking_federate_learning_tpu_torch.utils.metrics import (
        RunLogger
    )
    from attacking_federate_learning_tpu_torch.utils.profiling import (
        PhaseTimer, device_trace
    )

    parser = build_parser()
    args = parser.parse_args(argv)
    if os.environ.get(_build.BUILD_DIR_ENV):
        # A campaign's supervised child: its kernel libraries' build
        # directory (campaigns/scheduler.py child_env).
        _build.set_build_dir(os.environ[_build.BUILD_DIR_ENV])
    if (args.attack in ("backdoor", "backdoor_timed")
            and args.backdoor == "No"):
        # BackdoorAttack's poison set is derived from the -b trigger; an
        # explicit --attack backdoor without one would build an empty set.
        parser.error(f"--attack {args.attack} requires a trigger: "
                     f"-b pattern|1|2|3")
    if args.attack == "backdoor_timed" and args.aggregation != "async":
        # The timing channel only exists where arrival time matters.
        parser.error("--attack backdoor_timed games the async arrival "
                     "schedule (delay-0 emission); it requires "
                     "--aggregation async")
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    # A journaled run gets an event log of its own, named by its run id
    # (the reference CSV name encodes no seed).
    run_id = (args.run_id or run_id_for(cfg)
              if (args.journal or args.run_id) else None)

    # The JSONL handle is closed and the accuracy CSV written even when
    # the run raises.
    with RunLogger(cfg, cfg.output, cfg.log_dir, jsonl_name=run_id,
                   heartbeat_every=args.heartbeat) as logger:
        logger.dump_config()
        dataset = load_dataset(cfg.dataset, cfg.data_dir, cfg.seed,
                               synth_train=cfg.synth_train,
                               synth_test=cfg.synth_test)
        attacker = make_attacker(cfg, dataset=dataset,
                                 name=None if args.attack == "auto"
                                 else args.attack, device=device)
        exp = FederatedExperiment(cfg, attacker=attacker, dataset=dataset,
                                  device=device)
        # The journal comes before the checkpointer: a journaled run's
        # auto-checkpoints live in its own runs/<run_id>/.
        journal = None
        if run_id is not None:
            journal = RunJournal(cfg.run_dir, run_id)
            logger.print(f"[lifecycle] journal {journal.dir} "
                         f"(attempts so far: {journal.attempt})")
        auto_dir = journal.dir if journal is not None else None
        checkpointer = (None if args.no_checkpoint
                        else Checkpointer(cfg, auto_dir=auto_dir))
        if args.resume is not None:
            ckpt = checkpointer or Checkpointer(cfg, auto_dir=auto_dir)
            # 'auto': the newest checkpoint by round, autos and the best
            # one alike.
            path = (args.resume if args.resume != "auto"
                    else (ckpt.latest() or ckpt.path))
            if not os.path.exists(path):
                raise SystemExit(f"--resume: no checkpoint at {path}")
            if path.endswith((".pth.tar", ".pth", ".pt")):
                # A reference-produced torch checkpoint (reference
                # server.py:40-48).
                exp.state, ref_acc = import_reference_checkpoint(
                    path, expected_dim=exp.flat.dim, device=device)
                if checkpointer is not None:
                    checkpointer.best_acc = ref_acc
                logger.print(f"Imported reference checkpoint (acc {ref_acc})")
            else:
                exp.state, extra = ckpt.resume(path, with_extra=True,
                                               device=device)
                exp.restore_carry_state(extra)
                if checkpointer is not None:
                    # keep_best seeding: autos record accuracy -1, so the
                    # best checkpoint's own accuracy still wins.
                    import numpy as np

                    with np.load(path) as z:
                        acc = float(z["accuracy"])
                    checkpointer.best_acc = max(
                        acc, checkpointer.load_best_acc())
            logger.print(f"Resumed from round {int(exp.state.round)}")
        if args.cost_report:
            # The counted cost of every entry point, before training, on a
            # second engine: the run after it is the run without it.
            ledger = exp.cost_report(logger)
            for rec in ledger.records:
                peak = (f"{rec.peak_bytes / 1e6:.1f} MB"
                        if rec.peak_allocated is not None
                        else "not measured")
                logger.print(
                    f"[cost] {rec.name:16s} flops={rec.flops:.3e}  "
                    f"bytes={rec.bytes_accessed:.3e}  peak={peak}")
            for rec in ledger.compiles:
                logger.print(f"[cost] library {rec.name}: compile="
                             f"{rec.compile_s:.2f}s ({rec.cache})")
            for name, msg in ledger.errors:
                logger.print(f"[cost] {name}: analysis failed: {msg}")
        timer = PhaseTimer() if args.profile else None
        # SIGTERM/SIGINT become a checkpoint and exit 75 at the next host
        # boundary; FL_PREEMPT_AT_ROUND is the deterministic injection.
        pre_at = os.environ.get("FL_PREEMPT_AT_ROUND")
        shutdown = GracefulShutdown(
            preempt_at_round=int(pre_at) if pre_at else None)
        try:
            # --trace-dir: the whole run in one capture (JAX's xla_trace).
            with device_trace(args.trace_dir, device), shutdown:
                result = exp.run(logger, checkpointer=checkpointer,
                                 journal=journal, shutdown=shutdown,
                                 timer=timer)
        except Preempted as e:
            logger.print(f"[lifecycle] {e}")
            raise SystemExit(EXIT_PREEMPTED)
        except FloatingPointError as e:
            # Deterministic numeric failure (watchdog rollbacks exhausted,
            # or the backdoor's NaN guard): a retry would repeat it.
            logger.record(kind="lifecycle", phase="fatal",
                          failure="divergence", error=str(e))
            logger.print(f"[lifecycle] fatal (divergence): {e}")
            if journal is not None:
                journal.finish("diverged", EXIT_DIVERGED, error=str(e))
                journal.close()
            raise SystemExit(EXIT_DIVERGED)
        if args.cost_report and exp.wall_records:
            print_walls_vs_modeled(exp, ledger, logger.print)
        if timer is not None:
            logger.print({"phase_timing": timer.summary()})
    return result


if __name__ == "__main__":
    main()
