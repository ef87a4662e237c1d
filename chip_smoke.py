#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``gigapaxos_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. build   — compile ``gigapaxos_tpu_torch/csrc/gp_step.cu``,
             ``csrc/gp_lifecycle.cu`` and ``csrc/gp_pack_rows.cu`` for
             sm_90a, one nvcc each, in parallel; print the build time,
             ptxas' registers, spills and static shared memory for every
             kernel (each instantiation of gp_step) and the card's name
             and power limit.
2. parity  — each kernel against its plain PyTorch version on the card,
             bit for bit, on seeded states (simulator steps plus lane fuzz
             with wrap +-15 and ballot-delta saturation) at every
             instantiation of gp_step (W in {8, 16, 32} with R in {1..5},
             W=8 with R=4, and the generic one at W=4, R=7), K <= W, at
             G=4,100 (bulk
             copies, a ragged last tile) and G=1,001 (unaligned leaf
             offsets: plain loads), both make_step faces with N in {1, 4}
             (heat on the packed face, donation on and off); the C
             launcher's plan against the wrapper's.
   lifecycle — every lifecycle kernel (create, kill, jump, restore_paused,
             restore_rows, extract_rows) against its plain version, bit
             for bit, on seeded random states (NULL and negative words,
             full 32-bit masks) at the server shape (G=65,536, W=16; N in
             {1, 7, 4,096, 16,384}) and the headline shape (G=1,048,576, W=32;
             N=4,096) and the reconfigurators' shape (G=64, W=16; N=1),
             a sharded worker's (G=32,768, W=16; N in {1, 7, 64}) and the
             chaos and transaction soaks' (G in {24, 8, 16, 48}, W=8; N in
             {1, 7, G}) and the recovery path's (G=262,144, W=8; N in
             {1, 32,768}) and the launcher scenario's actives' (G=256, W=16;
             N=1) and the bank ledger's (G=131,072, W=4; N in {1, 1,696,
             32,768}, timed at 32,768); the input state unchanged, untouched leaves the input's own
             tensors, bad row batches refused, the kernels a call (one
             for every op); create, jump, restore_paused and restore_rows
             also at G=301,
             4,096 and 65,536, W in {4, 8, 16, 32}, N in {0, 1, 7, 64, G}, rows
             astride bitmap words, inputs on the card, a staged call
             launched twice; then each op's launch time (on the device: a
             CUDA graph of launches, the one-launch row ops at one and at
             four units a thread too; and by events around a loop), full
             call time and its staging by part (also at the server shape
             at N=1), plain and index_copy times.
   pack_rows — gp_pack_rows against pack_rows_plain, bit for bit, at
             (G=65,536, W=16, R=3), (65,536, 16, 4), (64, 16, 3),
             (64, 16, 4), the soaks' (24, 8, 4), (8, 8, 3) and
             (16, 8, 3) and the bank ledger's (131,072, 4, 3) on seeded and fuzzed blobs with numpy, card and
             CPU leaves mixed; then its launch time (device and events),
             the full call and its staging on the host's clock, the plain
             version and torch.cat of card-resident leaves, beside its
             bound; at G=64 the kernel and torch.cat again, in turns.
3. headline — the port's bench (testing/bench.py): the stacked face at
             G=1,048,576, W=32, K=16, R=3 under the bench's synthetic
             load, a steady arm and a failover arm (leadership rotation),
             each 2 chunks of 10 steps of warm-up and 5 timed chunks; a
             few steps of the plain version at this width beside the
             kernel after the warm-up, bit for bit; the RSM invariant on
             the kernel's states; committed decisions/s and the bench's
             JSON line, ms per replica-step on the device (a CUDA graph of
             launches) and its share of the bandwidth bound, the same on a
             quiet state (nothing decided), peak memory.  Then the bench's
             capacity arm at G=2,097,152 (its first 2 steps held against
             the plain version in tiles of 262,144 groups; no_oom, dec/s,
             peak memory over the timed chunks beside the footprint
             module's estimate) and its dispatch ablation at G=262,144
             (the N=8 and N=1 faces held against the plain version; per-
             step parity across N bit-exact, 480 against 60 host
             dispatches, both throughputs).  The steady arm's bench line
             and the ablation's result go to a temporary results directory
             (phase 15b folds them).
3b. residency — the N-substep dispatch: the packed face's N substeps as
             one gp_step_n launch and the stacked face's as one
             gp_step_cluster launch (a cluster of R CTAs a tile, R <= 8),
             each bit for bit against its plain face at every parity
             shape, G in {4,100, 1,001}, N in {2, 8} (packed: MY id 0 and
             R-1, heat, want at substep 0; stacked: every replica missing
             the last), against N serial one-substep dispatches at
             G=4,100, and at G=65,536 (W=16, R=3, K=8, N=8), where every
             CTA takes three tiles or more; one launch a dispatch and no
             gp_make_blob on the stacked face; the stacked face at N = 1
             (one gp_step launch, a CTA a tile of R replicas, gp_step_tile)
             at every parity shape and G against its plain face and the
             gp_make_blob + gp_step route it replaced; the packed
             dispatch at the server shape and the headline's width (one
             replica), N in {1, 4, 8}, and the stacked one at the
             ablation shape, N in {1, 8}, and the server shape, N=8, each
             bit for bit against the plain face, then on the device beside
             the N-launch design, the plain face and the bound (the state
             read and written once); then phase 6's servers at
             ENGINE_STEPS_PER_DISPATCH=8 (16 names, 2 requests each, 4
             names hibernated and restored, 1 more each): every response
             correct, each manager one gp_step_n a dispatch and no gp_step.
   step shapes — the manager's dispatch step (heat in place and fresh)
             and gp_make_blob against the plain version, bit for bit, for
             every replica id, at the server's shape (G=65,536, W=16, K=8,
             R=3), the density path's (G=65,536, W=16, K=4, R=1), the
             actives' (G=65,536, W=16, K=8, R=4), the reconfigurators'
             (G=64, W=16, K=8, R=3), a sharded worker's (G=32,768, W=16,
             K=8, R=3) and the soaks' (G, W, K, R) = (24, 8, 4, 4),
             (8, 8, 4, 3), (16, 8, 4, 3) and (48, 8, 4, 1) and the
             recovery path's (262,144, 8, 4, 1), the launcher
             scenario's actives' (256, 16, 8, 3) and the bank ledger's
             (131,072, 4, 2, 3), the generic instantiation: every shape
             that a later phase launches a kernel at; then their times (device and events),
             each step's share of its bound and its launch plan.
4. density — testing/density.py on the card: 1,048,576 names on 65,536
             rows (W=16, K=4, one replica, packed spill in a temporary
             directory): boot by batched create + hibernate, the per-name
             wake of 1,024 names against the batched wake of 4,096, 10 rounds of Zipfian
             churn; every request answered, every name accounted for.
5. state transfer — 3 managers (ManagerCluster) at the server shape,
             batching off: replica 2 dies, the others run more than 5W
             slots ahead, replica 2 restarts from its journal and adopts a
             donor's frontier (gp_jump_rows, one kernel a call); all
             three agree.
6. server  — 3 PaxosServers on loopback sockets in this process, on the
             card at G=65,536, W=16, K=8, R=3, with StatefulAdderApp and
             PaxosClientAsync: a few dozen names, a few hundred requests;
             every response is the expected running total, all replicas
             agree, every manager launched gp_step; requests/s, p50/p99.
             Then the admin plane hibernates 8 names on every server and
             restores them, and 64 more requests continue the totals.
7. rc_stepped — ReconfigurableCluster on the card (actives G=65,536,
             W=16, K=8, R=4; reconfigurators G=64, R=3; HashChainApp):
             create -> request -> migrate -> delete -> re-create, then a
             migration under a seeded 30% loss of reconfiguration-plane
             messages; every manager tick launches gp_pack_rows.
8. reconfiguration — ReconfigurableNode AR0..AR3 and RC0..RC2 on loopback
             ports in this process, configured by properties alone (the
             nodes' own engine defaults, the card as their default
             device), HashChainApp, ReconfigurableAppClient: 128 batched
             creates (cut from 1,024), 8 single ones, 4 requests on each
             of 64 names (every response the next link of the name's hash
             chain, every member's state equal), 16 migrations onto a set
             with an outside active plus a stale-cache request each, 16
             deletes (rows freed on every former member, records purged
             on every reconfigurator); creates/s, latencies, req/s,
             launches.
10. sharded — ReconfigurableNode AR0..AR2, each with SERVING_WORKERS=2
             worker processes on the card (ENGINE_ROWS=65,536 split to
             32,768 rows a worker, W=16, K=8, R=3, HashChainApp by
             APPLICATION; the parent builds the kernels before it spawns),
             and RC0..RC2 in this process, on loopback ports, configured by
             properties alone: 64 batched creates, 4 requests on each name
             (every response the next link of its hash chain), every
             member's state equal (the admin plane's app_state op, sent to
             the name's shard), names on both shards as shard_of_name
             places them, a CREATE through RC0's HTTP front and a request
             POSTed to the owning worker's front, GET /stats and /metrics
             from both, 8 deletes (rows freed on every member); every
             worker of every active launched gp_step (its counts and card
             memory from the stats admin op); req/s, p50/p99 and ticks/s
             per worker beside phase 6's, each over its request window.
   sharded_rows — the control: the same deployment with each worker at
             65,536 rows (ENGINE_ROWS=131,072), so that ticks/s per
             process stand beside phase 6's at equal rows per engine.
11. txn    — ManagerCluster of 3 managers on the card with
             TxnApp(StatefulAdderApp()) at the server shape: 16
             transactions over 2-4 of 16 groups each, 8 at once (balances
             equal on every member, conserved, equal to the committed
             history, no lock left); the coordinator-crash commit arm
             (journals in a temporary directory, all members restart, the
             resolver re-drives the commit); run_txn_soak(786083501) at its
             own shape through the chaos sweep's main (testing/chaos_sweep.py
             --family txn --count 1: the seed run, failed_seeds empty).
11b. ledger — the bank-ledger workload (scenarios/bank_ledger.py) through
             its main on the card at its published shape: 100,000 accounts
             on 131,072 rows (W=4, K=2, R=3), Zipf 1.05, amounts up to 9,
             32 in flight, seed 1; only the transaction count cut (128, from
             the artifact's 400).  All four audits pass (replicas agree, no
             lock or staged op left, conservation, per-name ledger), at
             least one transaction commits, and the path launched gp_step,
             gp_make_blob, gp_create_groups and gp_pack_rows; boot s, txn/s,
             commit p50/p99, steps and ms per cluster step.
12. chaos  — one pinned seed each, at the harness's own shapes, on the
             card: run_soak(1234) and run_density_soak(1) on the scripted
             clock of testing/clock.py in a child interpreter with
             PYTHONHASHSEED=0 (one seed, one schedule on every call), each
             held to the same soak on the CPU in another such child (equal
             results, ticks, steps and scripted seconds);
             run_sharded_soak(20260804, workers=2) on the wall clock (its
             workers are processes the clock cannot reach); the multistep
             pinned seed run_soak(662625602, rounds=30) at
             ENGINE_STEPS_PER_DISPATCH=4 on the scripted clock, card and
             CPU equal, its dispatches gp_step_n launches; steps, ticks
             and seconds; any SoakDivergence fails the run.
13. recovery — testing/recovery.py on the card at the JAX package's
             recovery probe's published defaults, uncut: 262,144 names on
             262,144 rows (W=8, K=4, one replica), 2,048 names driven
             before a 16-shard checkpoint, 32,768 after it into a journal
             of 4 MB files, 512 B app states; a cold restart with 4 replay
             workers and 1,024 hot names, then the eager baseline.  Every
             name holds its expected total after full hydration, the hot
             name is answered while the node is still recovering, the
             journal spans at least 2 files, the restarted leaves equal the
             crashed node's last leaves and a CPU restart's of the same
             directory bit for bit, and the restarted manager launched
             gp_step and gp_make_blob; restart-to-serving, first-serve,
             full-hydration, eager, replay, create and checkpoint seconds
             and the directory's bytes.
13b. heal  — the heal paths of the JAX package's tests at the deployed
             shapes, on the card: the epoch-commit ack matrix and the
             committed RESUME's heal shapes on an active's manager at the
             server shape; the READY audit re-joining a member that lost
             its row (ReconfigurableCluster at phase 7's shapes); both
             frontier-stall scenarios (ManagerCluster at the server shape:
             a straggler 2 slots behind a majority that paused and
             resumed, and a majority blank-rejoined behind one resumed
             member) healed by the state pull and gp_jump_rows; the
             epoch-final-state guard; a secondary reconfigurator finishing
             a migration after the primary dies; the demand-driven
             migration; the placement plane moving a hot name onto the
             idle active.  Each scenario's own checks within a step cap
             and a wall budget; its launches; every kernel shape launched
             must be one phases 2-3 hold against the plain version, and
             gp_jump_rows must launch in each frontier-stall scenario,
             one kernel a call.
14. mesh   — the mesh faces of make_step at the headline shape
             (G=1,048,576, W=32, K=16, R=3), every logical device on this
             card: the ('g',) face over 4 shards, also at G=1,048,573
             (padded), and the (g, r) face over 2 x 3, three steps (the
             first with an election pulse) bit for bit against the stacked
             face (which phase 3 holds against the plain version); a fault
             step of the (g, r) face (replica 2 unheard, replica 0
             pulsing) against its plain version; N=4 against four N=1
             calls; the golden cases of tests/test_unified_step.py (G=13
             over 8 shards and over 2 x 3) and the dry run's shapes on the
             card against the same meshes on the CPU.  The packed face
             (one replica's state split over 'g', heat on) over both
             meshes at the server shape, N in {1, 4}, bit for bit against
             the one-device packed face and its own plain version, and at
             the headline's one replica, N=1 (also G=1,048,573 over
             ('g',)), against the one-device face; ms a dispatch beside
             the one-device face's, the gathered matrix's slicing and the
             outputs' reassembly against their bound (bytes read and
             written at the card's memory rate), each logical device's
             launches (one gp_step, at N=4 one gp_step_n, a dispatch).
             Then, the counts from 0 before each, 20 steps of each face under the bench's
             load (dec/s beside the stacked face's; each logical device's
             own launches: on ('g',) one gp_step a step, on (g, r) one
             gp_make_blob and one gp_step), the
             (g, r) blob exchange's ms per step against its bound
             (r(r-1) G 528 B read and written at the card's memory rate),
             peak memory; the bench's multichip arm over the physical cards
             (its result to the results directory) and
             graft_entry.dryrun_multichip(8) on the card.  One card
             measures no multi-card speed.
15. ops    — the operating faces on the card: the port's scenario
             (gigapaxos_tpu_torch/scenarios/loopback_3ar_3rc.properties on
             free loopback ports, at the nodes' default ENGINE_ROWS of
             65,536) booted by `gigapaxos_tpu_torch.gp_server start all`
             as six processes with their request tracers on; `status all`
             6 up; testing/probe.py --attach, the reference's ramp from 10
             req/s for at most 4 rounds (round 0 must be answered at the
             reference's 0.9; its latency is recorded);
             testing/gp_trace.py --props over the actives (a merged
             timeline with a consensus hop; mean and p99 per hop); every
             node's launches (each launched gp_step) and card memory;
             `stop all`, then `status all` 6 down with no pid file and no
             process left.  Then testing/probe.py at its own defaults (6
             processes at 64 rows; its capacity record to the results
             directory), and, while the call has spent less
             than 550 s since the build, its --in-process ramps with and
             without consensus (--unreplicated).
15b. baseline — testing/perf_baseline.py over the results directory:
             every required series and sane bands (validate), the steady
             headline in its card's band, --check-only reading it back.
16. report — the kernels line, then the device line (last).

Kernel launch counts are reset to 0 just before each main-path run
(phases 3 to 8, 3b's servers and dispatches, 10 to 13, 11b, each
scenario of 13b and 14's timed runs,
packed dispatches and entry points) and read
just after; parity and timing
launches do not count.  Phase 10's launches are its worker processes'
counts (read through the stats admin op at the phase's end) plus this
process's (the reconfigurators); phase 12's scripted soaks' are their
child's; phase 15's are its node processes' own (each process counts
from 0 when it starts), read through the stats admin op.  ``--phases a,b`` runs a subset and prints no report (for
iterating); ``--host-ms ROOT`` only times the host side of a create, a
jump, a restore_paused and a restore_rows call at N=1 on the port's tree
at ROOT (two trees, such as a parent and its change, are compared in
turns, one process each);
the contract run takes no arguments.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# sizes (the chip run uses these; tests of this script shrink them)
# 4100: bulk copies with a ragged last tile at every W (the plan keeps
# T >= 8 groups there); 1001 (not a multiple of 4): the leaf offsets inside
# a gathered row are not 16-byte aligned, so the launch fills its ring with
# plain loads
PARITY_GS = (4100, 1001)
PARITY_SHAPES = [          # (W, R, K): every fixed R of gp_step.cu, and the
    (8, 3, 4), (8, 5, 8), (16, 3, 8), (16, 5, 16), (32, 3, 16), (32, 5, 8),
    (8, 1, 4), (16, 1, 4), (16, 2, 8), (16, 4, 8), (32, 4, 16),
    (8, 4, 4),             # run_soak's actives (testing/chaos.py)
    (4, 7, 3),             # generic instantiation (runtime R and W)
]
HEADLINE = dict(G=1_048_576, W=32, K=16, R=3)
HEADLINE_PLAIN_STEPS = 3
# the bench's other arms (testing/bench.py): the capacity run at the
# reference's PINSTANCES_CAPACITY wall, whose plain version runs in G-tiles
# (its temporaries at full width are many times the state), and the
# dispatch ablation's shape, N=1 against N=8 steps per dispatch
CAPACITY = dict(HEADLINE, G=2_097_152)
CAPACITY_TILE, CAPACITY_PLAIN_STEPS = 262_144, 2
ABLATION = dict(HEADLINE, G=262_144)
ABLATION_PLAIN_STEPS = 2
SERVER = dict(G=65_536, W=16, K=8, R=3)
# the reconfiguration paths' engines: the actives' (ReconfigurableNode's
# defaults with 4 actives: ENGINE_ROWS, SLOT_WINDOW, K=8) and the
# reconfigurators' record engine (64 rows, 3 reconfigurators)
AR = dict(G=65_536, W=16, K=8, R=4)
RC = dict(G=64, W=16, K=8, R=3)
# the actives of the launcher's scenario (its ENGINE_ROWS; phase 15 boots
# it at the nodes' default instead, but a user starts it as committed)
SCENARIO = dict(G=256, W=16, K=8, R=3)
# the sharded deployment's worker processes per active, and a worker's
# engine (ENGINE_ROWS / SERVING_WORKERS rows)
SHARDED_WORKERS = 2
WORKER = dict(SERVER, G=SERVER["G"] // SHARDED_WORKERS)
# the chaos harness's and the transaction soak's own engines
# (testing/chaos.py): run_soak's actives and every soak's reconfigurators;
# run_sharded_soak's actives per shard and run_txn_soak's managers;
# run_density_soak's rows
CHAOS_ENGINES = {"soak_ar": dict(G=24, W=8, K=4, R=4),
                 "soak_rc": dict(G=8, W=8, K=4, R=3),
                 "soak_g16": dict(G=16, W=8, K=4, R=3),
                 "soak_density": dict(G=48, W=8, K=4, R=1)}
# requests a name halved (from 10) to make room for the ledger phase
SERVER_NAMES, SERVER_REQS_PER_NAME = 32, 5
TIMING_ITERS = 30
WATCHDOG_S = 1140.0
# the recovery probe's published defaults (scripts/recovery_probe.py:75-96),
# uncut; its engine is one replica with K=4 (recovery_probe.py:109)
RECOVERY = dict(g=262_144, names=262_144, active=2048, tail=32_768,
                pad_bytes=256, state_bytes=512, window=8, shards=16, workers=4,
                hot=1024, journal_file_mb=4.0)
RECOVERY_ENGINE = dict(G=RECOVERY["g"], W=RECOVERY["window"], K=4, R=1)
# the bank-ledger workload (scenarios/bank_ledger.py, the JAX package's
# TXN_r01.json parameters): 100,000 accounts at its published Zipf, amount
# and replicas, 32 in flight (PC.TXN_MAX_INFLIGHT), seed 1; the one cut is
# the transaction count (the artifact ran 400).  Its engine: build_cluster
# sizes 1 << max(10, bit_length(accounts + 1)) rows at W=4, K=2
LEDGER = dict(accounts=100_000, txns=128, inflight=32, zipf=1.05, amount_max=9,
              replicas=3, seed=1)
LEDGER_ENGINE = dict(G=1 << max(10, (LEDGER["accounts"] + 1).bit_length()), W=4,
                     K=2, R=LEDGER["replicas"])
LEDGER_CREATE_CHUNK = 32_768     # bank_ledger.CREATE_CHUNK
# lifecycle parity and timing: (G, W, batch sizes)
# (16,384 is the density path's boot chunk)
LIFE_SHAPES = {"server": (65_536, 16, (1, 7, 4096, 16_384)),
               "headline": (1_048_576, 32, (4096,)),
               "rc": (RC["G"], RC["W"], (1,)),
               "worker": (WORKER["G"], WORKER["W"], (1, 7, 64)),
               **{k: (d["G"], d["W"], (1, 7, d["G"]))
                  for k, d in CHAOS_ENGINES.items()},
               # the recovery path's creates: one name, and the probe's
               # create chunk (recovery_probe.py:124)
               "recovery": (RECOVERY_ENGINE["G"], RECOVERY_ENGINE["W"],
                            (1, 32_768)),
               # the launcher scenario's actives create, kill and restore
               # one name at a time (the probe's 64-row actives are "rc")
               "scenario": (SCENARIO["G"], SCENARIO["W"], (1,)),
               # the ledger's boot: its coordinator, then 32,768-name
               # chunks and the last chunk's rest (1,696 names)
               "ledger": (LEDGER_ENGINE["G"], LEDGER_ENGINE["W"],
                          (1, LEDGER["accounts"] % LEDGER_CREATE_CHUNK,
                           LEDGER_CREATE_CHUNK))}
LIFE_TIMING_N = 4096
# shapes timed at another batch than LIFE_TIMING_N: the ledger's chunk
LIFE_TIMING_N_AT = {"ledger": LEDGER_CREATE_CHUNK}
# shapes also timed at a second batch (as "<shape>_n<N>"): the server
# shape at one name, a per-name wake's create and restore_paused
LIFE_TIMING_N_ALSO = {"server": 1}
# the lifecycle ops on gp_life_rows_kernel (csrc/gp_lifecycle.cu) and the
# edge cases they are also held at: G=301 (word units), 4,096 and 65,536
# (int4 units; four a thread at 65,536's sparse batches from W=8) at every
# W, N in {0, 1, 7, 64, G}
LIFE_ONE_PASS = ("gp_create_groups", "gp_jump_rows", "gp_restore_paused_rows",
                 "gp_restore_rows")
LIFE_EDGE_G, LIFE_EDGE_W = (301, 4096, 65_536), (4, 8, 16, 32)
DENSITY = dict(names=1_048_576, rows=65_536, window=16, req_lanes=4,
               boot_chunk=16_384, burst=4096, per_name_burst=1024,
               hot_pct=1.0, rounds=10, round_requests=512, zipf_a=1.2,
               seed=0)
# the step's shapes on the server, density and reconfiguration paths (the
# density manager runs one replica)
STEP_SHAPES = {"server": SERVER,
               "density": dict(G=DENSITY["rows"], W=DENSITY["window"],
                               K=DENSITY["req_lanes"], R=1),
               "ar": AR, "rc": RC, "worker": WORKER, **CHAOS_ENGINES,
               "recovery": RECOVERY_ENGINE, "scenario": SCENARIO,
               # the generic gp_step (W=4 has no fixed instantiation)
               "ledger": LEDGER_ENGINE}
# gp_pack_rows parity and timing: (G, W, R) of every tick that packs (the
# density soak runs one replica and packs nothing)
PACK_SHAPES = {"ar3": (65_536, 16, 3), "ar4": (65_536, 16, 4), "rc": (64, 16, 3),
               "rc4": (64, 16, 4),
               "ledger": (LEDGER_ENGINE["G"], LEDGER_ENGINE["W"], LEDGER_ENGINE["R"]),
               **{k: (d["G"], d["W"], d["R"]) for k, d in CHAOS_ENGINES.items()
                  if d["R"] > 1}}
PACK_TURNS = 3   # kernel and torch.cat timed in turns at the small shapes
# the socket deployment: names created in one batch (1,024 cut to 256:
# on an H100 host the batch alone took 941 s for 1,024 names; to 128 and
# the singles and requests a name halved to make room for the ledger
# phase), then one by one; names that take requests and requests each;
# names migrated; deleted
RC_BATCH_NAMES, RC_SINGLE_NAMES = 128, 8
RC_REQ_NAMES, RC_REQS_PER_NAME = 64, 4
RC_MOVES, RC_DELETES = 16, 16
ST_BATCHES, ST_BATCH_REQS = 10, 10   # slots driven past the straggler
SERVER_HIBERNATE, SERVER_POST_REQS_PER_NAME = 8, 2
# the sharded deployment: names created in one batch, requests on each
# (halved from 8 for the ledger phase), names deleted
SH_NAMES, SH_REQS_PER_NAME, SH_DELETES = 64, 4, 8
# transactions at the server shape: accounts (each starting at the
# balance), transactions (32 halved for the ledger phase, which takes the
# transaction plane to 100,000 groups) and how many run at once; then the
# soak's seed
TXN_SEED, TXN_ACCOUNTS, TXN_BALANCE = 20260804, 16, 1000
TXN_COUNT, TXN_INFLIGHT = 16, 8
TXN_SOAK_SEED = 786083501
# the chaos families' pinned seeds (tests/test_chaos.py,
# tests/test_serving_workers.py; run_density_soak's default seed)
CHAOS_SEED, CHAOS_SHARDED_SEED, CHAOS_DENSITY_SEED = 1234, 20260804, 1
# the operating faces (phase 15): the port's scenario booted at the nodes'
# default rows (the server shape), the probe's ramp against it (an init load
# the 65,536-row ticks sustain; the reference's factor, thresholds and
# window; at most 4 rounds, 8 until the ledger phase came), and the
# probe's own defaults (64 rows)
OPS_SCENARIO = os.path.join("gigapaxos_tpu_torch", "scenarios",
                            "loopback_3ar_3rc.properties")
OPS_ROWS = SERVER["G"]
OPS_INIT_LOAD, OPS_MAX_ROUNDS = 10.0, 4
OPS_ANSWERED = 0.9    # the probe's response-rate threshold (probe.py)
# 15.6 (the in-process ramps, about 120 s) runs only when the call has
# spent less than this since the build (650 s until the ledger phase came)
OPS_INPROC_BUDGET_S = 550.0

# the mesh faces (phase 14): the headline shape, one card holding every
# logical device; a G that does not divide over 4 shards; the ('g',)
# shards and the (g, r) mesh; steps of the rate runs; the dry run's
# logical devices; the golden cases of tests/test_unified_step.py and the
# dry run's shapes ((g, r) at W=4, K=2, R=2 and ('g',) at G=35, R=3),
# held on the card against the same meshes on the CPU
MESH = dict(HEADLINE)
MESH_G_PADDED = 1_048_573
MESH_G_SHARDS, MESH_GR = 4, (2, 3)
MESH_WARM_STEPS, MESH_TIMED_STEPS = 10, 20
MESH_DRYRUN_DEVICES = 8
# the packed face over the same meshes (the deployed runtime's face, one
# replica's state split over 'g'): (label, shape, substeps per dispatch,
# meshes, held against the mesh face's own plain version too); heat on
MESH_PACKED = [("server", SERVER, (1, 4), ("g", "gr"), True),
               ("headline", HEADLINE, (1,), ("g", "gr"), False),
               ("headline_padded", dict(HEADLINE, G=MESH_G_PADDED), (1,), ("g",), False)]
MESH_PACKED_ITERS = 10
MESH_SMALL = [("golden_g8", dict(G=13, W=8, K=4, R=3), "g", 8),
              ("golden_gr", dict(G=13, W=8, K=4, R=3), "gr", 2),
              ("dryrun_gr", dict(G=16, W=4, K=2, R=2), "gr", 4),
              ("dryrun_g8", dict(G=35, W=4, K=2, R=3), "g", 8)]

# the residency dispatch (phase 3b): substeps a dispatch held bit for bit
# against the plain faces at every parity shape and against N serial
# one-substep dispatches at the first parity G; the packed face timed at
# the server shape and the headline's width (one replica), the stacked face
# at the ablation and server shapes;
# then phase 6's servers at ENGINE_STEPS_PER_DISPATCH=8 (16 names, 2
# requests each (4 until the whole call's time was measured), 4 names
# hibernated and restored, 1 more request each).  The dispatches of the
# larger shapes are timed over a graph of 5 replayed 4 times (a dispatch
# there takes milliseconds)
RES_PARITY_N = (2, 8)
# a parity case where every CTA of both N-substep launches takes three tiles
# or more (4,096 tiles of 16 groups over some 400 CTAs; 8,192 of 8 over
# some 250 clusters), so the ring refills stages that the substeps wrote:
# the server shape's (W, R, K), the first parity G's seeded states tiled
RES_PARITY_BIG = (65_536, (16, 3, 8))
RES_PACKED_N = (1, 4, 8)
# the stacked face: (label, shape, N) timed; at the server shape's W=16 a
# substep's bytes weigh more against its compute than at the ablation's W=32
RES_STACKED = [("ablation", ABLATION, (1, 8)), ("server", SERVER, (8,))]
RES_SERVER_N = 8
RES_SERVER_NAMES, RES_SERVER_REQS_PER_NAME = 16, 2
RES_SERVER_HIBERNATE, RES_SERVER_POST_REQS_PER_NAME = 4, 1
# phase 12's multistep pinned seed (tests/test_unified_step.py's, at
# ENGINE_STEPS_PER_DISPATCH=4, as tests/test_torch_chaos_breach.py runs it)
CHAOS_MULTISTEP = dict(seed=662625602, rounds=30, steps_per_dispatch=4)

# the heal paths (phase 13b): each scenario's wall budget (the reference
# tests' 30-60 s deadlines, for their 16-row engines) and its step cap
HEAL_DEADLINE_S, HEAL_MAX_STEPS = 120.0, 600

# the lifecycle kernels: name, function of ops/lifecycle.py, the JAX
# function it replaces, and the path whose launches count ("parity" for
# the row ops only tests use, as in the reference)
LIFE_KERNELS = [
    ("gp_create_groups", "create_groups", "gigapaxos_tpu/ops/lifecycle.py:46", "density"),
    ("gp_kill_groups", "kill_groups", "gigapaxos_tpu/ops/lifecycle.py:95", "density"),
    ("gp_jump_rows", "jump_rows", "gigapaxos_tpu/ops/lifecycle.py:112", "state_transfer"),
    ("gp_restore_paused_rows", "restore_paused_rows",
     "gigapaxos_tpu/ops/lifecycle.py:163", "density"),
    ("gp_restore_rows", "restore_rows", "gigapaxos_tpu/ops/lifecycle.py:207", "parity"),
    ("gp_extract_rows", "extract_rows", "gigapaxos_tpu/ops/lifecycle.py:201", "parity"),
]
def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bandwidth(name: str) -> float:
    """Published device-memory rate (bytes/s) for the card's name."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    return 3.35e12  # H100 SXM (80GB HBM3)


def step_bytes(G: int, W: int, K: int, R: int) -> int:
    """Bytes one replica-step must move: state read + written, R gathered
    blob rows, K request words, the out vector and the blob written, the
    want byte per group and R heard bytes."""
    words = 2 * (12 + 7 * W) + R * (4 + 4 * W) + K + (6 + 3 * W) + (4 + 4 * W)
    return G * (4 * words + 1) + R


def stacked_step_bytes(G: int, W: int, K: int, R: int) -> int:
    """Bytes one stacked launch (all R replicas) must move, per replica:
    as :func:`step_bytes`, except that the [R, NB] blob matrix every
    replica gathers from is read once per launch, not once per replica."""
    words = 2 * (12 + 7 * W) + K + (6 + 3 * W) + (4 + 4 * W)
    per_launch = R * G * (4 * words + 1) + R * G * 4 * (4 + 4 * W) + R * R
    return per_launch // R


def packed_bytes(G: int, W: int, K: int, R: int, N: int) -> int:
    """Bytes the packed face's N-substep dispatch must move: one replica's
    state read and written once, the R gathered rows read once, N request
    tiles read and N out rows written, the blob written once, the heat
    read and written, the want byte per group and R heard bytes."""
    words = (2 * (12 + 7 * W) + R * (4 + 4 * W) + N * K + N * (6 + 3 * W)
             + (4 + 4 * W) + 2)
    return G * (4 * words + 1) + R


def cluster_bytes(G: int, W: int, K: int, R: int, N: int) -> int:
    """Bytes the stacked face's N-substep dispatch must move: every
    replica's state read and written once, its N request tiles read and
    its N out rows written, its want bytes, the heard matrix.  The blobs
    the replicas exchange never need device memory."""
    words = R * (2 * (12 + 7 * W) + N * K + N * (6 + 3 * W))
    return G * (4 * words + R) + R * R


def blob_bytes(G: int, W: int) -> int:
    """Bytes gp_make_blob moves: the 12 state leaves it reads and the blob."""
    return G * 4 * ((5 + 7 * W) + (4 + 4 * W))


# the touched leaves whose batch rows' input words a lifecycle op reads:
# jump's bal (the max with the donor's) and the window planes whose lanes
# at and above the new frontier it keeps (the kept slot planes decide);
# every other touched word of a batch row, and every op but jump, comes
# from the batch inputs and constants alone
LIFE_BATCH_READS = {"gp_jump_rows": ("bal", "acc_bal", "acc_vid", "acc_slot",
                                     "dec_vid", "dec_slot")}


def lifecycle_bytes(name: str, G: int, W: int, N: int) -> int:
    """Bytes one lifecycle op must move: every leaf it touches written
    once, read once in its G - N other rows, and in its N batch rows only
    where the op reads them (``LIFE_BATCH_READS``), the N row indices and
    its batch inputs read once (all int32; the leaves from
    gp_kernels.TOUCHED and INPUTS).  extract_rows reads N whole rows
    (12 + 7W words) and writes them."""
    from gigapaxos_tpu_torch.ops.gp_kernels import GW_LEAVES, INPUTS, TOUCHED

    words = lambda leaves: sum(W if f in GW_LEAVES else 1 for f in leaves)
    if name == "gp_extract_rows":
        return 4 * (N + 2 * N * (12 + 7 * W))
    touched = words(TOUCHED[name])
    return 4 * ((2 * G - N) * touched + N * words(LIFE_BATCH_READS.get(name, ()))
                + N * (1 + words(INPUTS[name])))


def ptxas_summary(text: str) -> list:
    """ptxas' ``-v`` report as one entry per kernel: its name (gp_step's
    instantiations as ``gp_step<R,W>``, R = W = 0 the generic one;
    gp_life_rows_kernel's as ``gp_life_rows<op,VG,VW,units>``, op the
    code of gp_lifecycle.cu), its registers, stack frame, spill bytes and
    static shared memory."""
    import re

    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"gp_step_kernelILi(\d+)ELi(\d+)E", name)
            life = re.search(r"gp_life_rows_kernelILi(\d+)ELb([01])ELb([01])ELi(\d+)E", name)
            if t:
                name = f"gp_step<{t.group(1)},{t.group(2)}>"
            elif life:
                name = "gp_life_rows<{},{},{},{}>".format(*life.groups())
            else:
                t = re.search(r"\d+(gp_\w+?_kernel)", name)
                name = t.group(1) if t else name
            cur = {"kernel": name, "registers": None, "stack": None, "spill_stores": None,
                   "spill_loads": None, "smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def host_ms(fn, iters: int) -> float:
    """Mean wall time of ``fn`` in ms on the host's clock, the card
    synchronized before and after the loop (for calls whose time is
    mostly host work)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """A launch's time on the device: ``calls`` calls of ``fn`` (launches
    only: no host synchronisation, no host-to-device copy) captured in one
    CUDA graph, the graph replayed ``reps`` times between CUDA events; ms
    per call.  The replay re-issues the captured kernels with no Python
    in between, so below about 0.2 ms this reads the kernel and not the
    wrapper (:func:`cuda_ms` times a loop of wrapper calls)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (calls * reps)
    del g
    return ms


def pack_bytes(G: int, W: int, R: int) -> int:
    """Bytes gp_pack_rows must move: the R packed rows' words read once
    from the leaves and written once."""
    return 2 * R * G * (4 + 4 * W) * 4


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


class Diff:
    """Bit-exact comparison bookkeeping across phases."""

    def __init__(self):
        names = ("gp_step", "gp_step_n", "gp_step_cluster", "gp_make_blob",
                 "gp_pack_rows")
        self.max_abs = {k: 0 for k in names}
        self.checked = {k: 0 for k in names}
        for name, *_ in LIFE_KERNELS:
            self.max_abs[name] = 0
            self.checked[name] = 0

    def same(self, kernel: str, what: str, ok: bool) -> None:
        """A check that is not a word comparison (identity, a refusal)."""
        self.checked[kernel] += 1
        if not ok:
            fail(f"{kernel} {what}")

    def eq(self, kernel: str, what: str, a, b) -> None:
        import torch

        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            fail(f"{kernel} {what}: shape/dtype {tuple(a.shape)} {a.dtype} "
                 f"vs {tuple(b.shape)} {b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        m = int(d.max()) if d.numel() else 0
        self.max_abs[kernel] = max(self.max_abs[kernel], m)
        self.checked[kernel] += 1
        if m != 0:
            n = int((d != 0).sum())
            fail(f"{kernel} {what}: {n} words differ (max abs {m})")

    def tree(self, kernel: str, what: str, a, b) -> None:
        for f in a._fields:
            self.eq(kernel, f"{what}.{f}", getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# phase 2: seeded states
# ---------------------------------------------------------------------------


_SEEDED: dict = {}


def seeded_states(cfg, seed: int, device):
    """:func:`make_seeded_states`, kept per (shape, seed, device): phases 2
    and 3b fold the same states at the parity shapes (3b drops them)."""
    key = (tuple(cfg), seed, str(device))
    if key not in _SEEDED:
        _SEEDED[key] = make_seeded_states(cfg, seed, device)
    return _SEEDED[key]


def make_seeded_states(cfg, seed: int, device):
    """R replica states of a CPU simulator after a few loaded steps, then
    lane fuzz: random lanes get slots at wrap deltas up to +-15 (and one
    past), ballots at deltas up to DELTA_MAX (and past), random vids with
    stop bits; some groups get random phases, member masks and tags."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.sim import SimCluster

    G, W, K, R = cfg
    rng = np.random.default_rng(seed)
    sim = SimCluster(cfg, check=False, device="cpu")
    sim.create_all_groups()
    vid = 1
    for t in range(6):
        reqs = {}
        for r in range(R):
            a = np.where(rng.random((G, K)) < 0.5,
                         np.arange(vid, vid + G * K).reshape(G, K), -1)
            vid += G * K
            reqs[r] = a.astype(np.int32)
        want = {int(rng.integers(0, R)): rng.random(G) < 0.05} if t == 2 else {}
        delivery = rng.choice([0, 1, 2], size=(R, R), p=[0.8, 0.1, 0.1])
        sim.step_all(reqs=reqs, want_coord=want, delivery=delivery)
    kb = W.bit_length() - 1
    out = []
    for st in sim.states:
        d = {k: v.numpy().copy() for k, v in st._asdict().items()}
        eb = d["exec_slot"] >> kb
        lanes = np.arange(W)
        for key in ("acc_slot", "dec_slot", "c_prop_slot"):
            eps = rng.integers(-16, 17, size=(G, W))
            fuzz = ((eb[:, None] + eps) << kb) | lanes
            m = rng.random((G, W)) < 0.15
            d[key] = np.where(m, fuzz, d[key]).astype(np.int32)
        m = rng.random((G, W)) < 0.15
        dlt = rng.choice([0, 1, te.DELTA_MAX - 1, te.DELTA_MAX,
                          te.DELTA_MAX + 1, 70000], size=(G, W))
        d["acc_bal"] = np.where(m, d["bal"][:, None] - dlt,
                                d["acc_bal"]).astype(np.int32)
        for key in ("acc_vid", "dec_vid", "c_prop_vid"):
            m = rng.random((G, W)) < 0.1
            v = rng.integers(-1, 10_000, size=(G, W))
            v = np.where(rng.random((G, W)) < 0.1, v | (1 << 30), v)
            d[key] = np.where(m, v, d[key]).astype(np.int32)
        g = rng.random(G) < 0.1
        d["c_phase"] = np.where(g, rng.integers(0, 3, G), d["c_phase"])
        d["member_mask"] = np.where(rng.random(G) < 0.05,
                                    rng.integers(0, 2 ** R, G), d["member_mask"])
        d["tag"] = np.where(rng.random(G) < 0.03, d["tag"] + 1, d["tag"])
        out.append(te.EngineState(**{
            k: torch.as_tensor(np.asarray(v, np.int32), device=device)
            for k, v in d.items()
        }))
    return out


def plan_str(plan: dict) -> str:
    """The C launcher's plan (``gp_kernels.step_launch_plan``) in words."""
    inst = plan["instance"]
    inst = f"R{inst // 100}W{inst % 100}" if inst else "generic"
    return (f"{inst}, T={plan['T']}, "
            f"{plan['threads']} threads, {plan['smem_bytes']} B shared, "
            f"{plan['ctas_per_sm']} CTAs/SM, grid {plan['grid']} over "
            f"{plan['n_items']} items, {'bulk' if plan['aligned'] else 'plain'} loads")


def phase_parity(diff: Diff, device) -> None:
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step, stack_states

    t0 = time.perf_counter()
    shapes = [(G, i, dims) for G in PARITY_GS for i, dims in enumerate(PARITY_SHAPES)]
    for G, i, (W, R, K) in shapes:
        cfg = te.EngineConfig(G, W, K, R)
        states = seeded_states(cfg, 100 + i + G, device)
        rng = np.random.default_rng(200 + i + G)
        for s in states:
            diff.eq("gp_make_blob", f"G{G}W{W}R{R}.blob",
                    gp_kernels.make_blob_vec(s),
                    te.pack_blob(te.make_blob_plain(s)))
        gvec = torch.stack([te.pack_blob(te.make_blob_plain(s)) for s in states])
        dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        for my_id in range(R):
            heard = dev(rng.random(R) < 0.85, torch.bool)
            req = rng.integers(1, 10 ** 6, size=(G, K))
            req = np.where(rng.random((G, K)) < 0.3, -1, req)
            req = np.where(rng.random((G, K)) < 0.03, req | (1 << 30), req)
            req = dev(req.astype(np.int32), torch.int32)
            want = dev(rng.random(G) < 0.1, torch.bool)
            heat = dev(rng.integers(0, 100, G).astype(np.int32), torch.int32)
            st = states[my_id]
            k_st, k_out, k_blob, k_heat = gp_kernels.step(
                st, gvec, heard, req, want, my_id, cfg, with_blob=True, heat=heat,
            )
            p_st, p_out = te.step_plain(
                st, te.unpack_gathered(gvec, cfg), heard, req, want, my_id, cfg
            )
            tag = f"G{G}W{W}R{R}K{K}.r{my_id}"
            diff.tree("gp_step", tag + ".state", k_st, p_st)
            diff.eq("gp_step", tag + ".out", k_out, te.pack_out(p_out))
            diff.eq("gp_step", tag + ".blob", k_blob,
                    te.pack_blob(te.make_blob_plain(p_st)))
            diff.eq("gp_step", tag + ".heat", k_heat,
                    heat + p_out.n_committed + p_out.n_admitted)
        # both faces, N in {1, 4}, heat, donation on and off
        for N in (1, 4):
            ring = rng.integers(1, 10 ** 6, size=(N, G, K))
            ring = np.where(rng.random((N, G, K)) < 0.3, -1, ring)
            ring = dev(ring.astype(np.int32), torch.int32)
            want = dev(rng.random(G) < 0.05, torch.bool)
            heard = dev(np.ones(R, bool), torch.bool)
            heat = torch.zeros(G, dtype=torch.int32, device=device)
            for donate in (False, True):
                fn = make_step(cfg, None, N, donate=donate, io="packed_host",
                               heat=True, device=device)
                p = fn.plain(states[0], gvec, heard, ring, want, 0, heat)
                # a second dispatch on the first one's output
                st0 = te.EngineState(*(x.clone() for x in states[0]))
                k = fn(st0, gvec, heard, ring, want, 0, heat.clone())
                tag = f"packed.G{G}W{W}R{R}.N{N}.d{int(donate)}"
                # N > 1 is one gp_step_n launch a dispatch
                kname = "gp_step" if N == 1 else "gp_step_n"
                diff.tree(kname, tag + ".state", k[0], p[0])
                for j in (1, 2, 3):
                    diff.eq(kname, f"{tag}.{j}", k[j], p[j])
                p2 = fn.plain(p[0], gvec, heard, ring, want, 0, p[3])
                k2 = fn(k[0], gvec, heard, ring, want, 0, k[3])
                diff.tree(kname, tag + ".again.state", k2[0], p2[0])
                for j in (1, 2, 3):
                    diff.eq(kname, f"{tag}.again.{j}", k2[j], p2[j])
            fn = make_step(cfg, None, N, donate=False, io="stacked", device=device)
            stacked = stack_states(states)
            reqs = rng.integers(1, 10 ** 6, size=(N, R, G, K))
            reqs = np.where(rng.random((N, R, G, K)) < 0.3, -1, reqs)
            reqs = dev(reqs.astype(np.int32), torch.int32)
            if N == 1:
                reqs = reqs[0]
            wants = dev(rng.random((R, G)) < 0.05, torch.bool)
            hm = dev(rng.random((R, R)) < 0.8, torch.bool)
            k_st, k_o = fn(stacked, reqs, wants, hm)
            p_st, p_o = fn.plain(stacked, reqs, wants, hm)
            kname = "gp_step_cluster" if fn.route == "cluster" else "gp_step"
            diff.tree(kname, f"stacked.G{G}W{W}R{R}.N{N}.state", k_st, p_st)
            diff.tree(kname, f"stacked.G{G}W{W}R{R}.N{N}.out", k_o, p_o)
    torch.cuda.synchronize()
    log(f"parity: {diff.checked} comparisons bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 2b: the lifecycle kernels
# ---------------------------------------------------------------------------


def random_state(G: int, W: int, seed: int, device):
    """A seeded random EngineState: window words in [-1, 400) (NULL = -1
    included), full-range 32-bit app hashes and member masks."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops.gp_kernels import GW_LEAVES

    rng = np.random.default_rng(seed)
    d = {}
    for f in te.EngineState._fields:
        shape = (G, W) if f in GW_LEAVES else (G,)
        d[f] = rng.integers(-1, 400, size=shape, dtype=np.int32)
    for f in ("app_hash", "member_mask"):
        d[f] = rng.integers(-2 ** 31, 2 ** 31 - 1, size=G, dtype=np.int32)
    return te.EngineState(**{k: torch.as_tensor(v, device=device)
                             for k, v in d.items()})


def life_args(name: str, rng, G: int, W: int, N: int, other, host_rows=False):
    """Seeded arguments of one lifecycle op (after the state): N unique
    rows and the op's batch inputs, on the host as the manager passes
    them; restore_rows' rows are gathered from ``other`` on the card
    (``host_rows``: copied to the host)."""
    import numpy as np

    from gigapaxos_tpu_torch.ops import lifecycle as tl

    idx = rng.choice(G, size=N, replace=False)
    n = lambda lo, hi: rng.integers(lo, hi, size=N)
    if name == "gp_create_groups":
        masks = rng.integers(-2 ** 31, 2 ** 31 - 1, size=N)
        masks[::2] = rng.integers(1, 8, size=masks[::2].shape)
        coord0 = tl.initial_coordinator(idx, masks & 7)
        return (idx, masks, coord0), dict(my_id=1, version=n(0, 4), tag=n(1, 1 << 30))
    if name == "gp_jump_rows":
        return (idx, n(-1, 500), n(-1, 500), n(-2 ** 31, 2 ** 31 - 1),
                n(0, 9), n(0, 2)), {}
    if name == "gp_restore_paused_rows":
        return (idx, n(-1, 500), n(-1, 500), n(-2 ** 31, 2 ** 31 - 1),
                n(0, 9)) + tuple(rng.integers(-1, 500, size=(N, W))
                                 for _ in range(5)), {}
    if name == "gp_restore_rows":
        rows = tl.extract_rows_plain(other, rng.choice(G, size=N, replace=False))
        if host_rows:
            rows = tuple(r.cpu().numpy() for r in rows)
        return (idx, rows), {}
    return (idx,), {}   # kill, extract


def life_kernels_a_call(name: str, N: int) -> int:
    """Kernels one lifecycle call launches: extract one gather for N > 0;
    every other op one launch."""
    return int(N > 0) if name == "gp_extract_rows" else 1


def library_fn(name: str, state, want, idx_t):
    """One PyTorch call per leaf computing the same function (timed as
    the yardstick, used nowhere in the port): ``index_copy`` of the
    result rows into every touched leaf, ``index_select`` for the
    gather."""
    from gigapaxos_tpu_torch.ops.gp_kernels import TOUCHED

    if name == "gp_extract_rows":
        return lambda: [leaf.index_select(0, idx_t) for leaf in state]
    rows = [(getattr(state, f), getattr(want, f)[idx_t]) for f in TOUCHED[name]]
    return lambda: [leaf.index_copy(0, idx_t, v) for leaf, v in rows]


def stage_parts(fn, iters: int) -> dict:
    """ms per call of each part of a lifecycle call's staging over
    ``iters`` calls of ``fn(parts)`` (``gp_kernels.stage(..., parts=)``),
    on the host's clock."""
    import torch

    fn(None)
    torch.cuda.synchronize()
    parts = {}
    for _ in range(iters):
        fn(parts)
    torch.cuda.synchronize()
    return {k: v * 1e3 / iters for k, v in sorted(parts.items())}


def time_life(name: str, fn: str, state, args, kw, G: int, W: int, N: int,
              device, bw: float) -> dict:
    """One lifecycle op's times at (G, W, N): the staged launch alone on
    the device (``graph_ms``: a CUDA graph of launches) and by the events
    around a loop of launches, its kernels a launch, the call's host side
    alone (checks, staging upload, outputs, argument block; and by its
    parts) and the whole call on the host's clock, the plain version and
    the per-leaf library calls, beside the bound."""
    import torch

    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.ops import lifecycle as tl

    staged = gp_kernels.stage(name, state, *args, **kw)
    ms = graph_ms(staged.launch)
    ms_events = cuda_ms(staged.launch, TIMING_ITERS)
    kernels = staged.kernels
    # the one-pass kernel at either unit count a thread (the launcher's
    # rule picks one)
    ms_units = {}
    if name in LIFE_ONE_PASS:
        for units in (1, 4):
            staged.args.units = units
            ms_units[units] = graph_ms(staged.launch)
        staged.args.units = 0
    stage = lambda parts=None: gp_kernels.stage(name, state, *args, parts=parts, **kw)
    ms_stage = host_ms(stage, TIMING_ITERS)
    parts = stage_parts(stage, TIMING_ITERS)
    ms_call = host_ms(lambda: getattr(tl, fn)(state, *args, **kw), TIMING_ITERS)
    plain = getattr(tl, fn + "_plain")
    want = plain(state, *args, **kw)
    plain_ms = cuda_ms(lambda: plain(state, *args, **kw), 5)
    idx_t = torch.as_tensor(args[0], dtype=torch.long, device=device)
    library_ms = graph_ms(library_fn(name, state, want, idx_t))
    nbytes = lifecycle_bytes(name, G, W, N)
    return {"G": G, "W": W, "N": N, "ms": ms, "ms_events": ms_events,
            "kernels_a_call": kernels, "ms_units": ms_units, "ms_call": ms_call,
            "ms_stage": ms_stage,
            "ms_stage_parts": parts, "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3}


# --host-ms: the shapes at N=1 and the runs of calls each median takes
HOST_MS_SHAPES = {"scenario": (SCENARIO["G"], SCENARIO["W"]),
                  "server": (SERVER["G"], SERVER["W"])}
HOST_MS_RUNS, HOST_MS_CALLS = 5, 200


def host_side_ms(device) -> dict:
    """The host side of one call of each op on ``gp_life_rows_kernel``
    (``LIFE_ONE_PASS``) at N=1 at each shape of ``HOST_MS_SHAPES``
    (restore_rows' rows gathered on the card, as ``extract_rows`` gives
    them): ``ms_call`` (the public wrapper)
    and ``ms_stage`` (``gp_kernels.stage`` alone), each the median of
    ``HOST_MS_RUNS`` runs of ``HOST_MS_CALLS`` calls on the host's clock,
    with the runs.  It uses only the wrappers' arguments, so it times any
    tree of the port (``--host-ms ROOT``) and two trees compare in turns,
    one process each."""
    import statistics

    import numpy as np

    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.ops import lifecycle as tl

    gp_kernels.lib("gp_lifecycle")
    out = {}
    for si, (shape, (G, W)) in enumerate(HOST_MS_SHAPES.items()):
        state = random_state(G, W, 400 + si, device)
        other = random_state(G, W, 500 + si, device)
        rng = np.random.default_rng(600 + si)
        for name in LIFE_ONE_PASS:
            fn = {k: f for k, f, *_ in LIFE_KERNELS}[name]
            args, kw = life_args(name, rng, G, W, 1, other)
            call = lambda: getattr(tl, fn)(state, *args, **kw)
            stage = lambda: gp_kernels.stage(name, state, *args, **kw)
            for key, f in (("ms_call", call), ("ms_stage", stage)):
                runs = [host_ms(f, HOST_MS_CALLS) for _ in range(HOST_MS_RUNS)]
                out[f"{shape} {name} {key}"] = {"median": statistics.median(runs),
                                                "runs": runs}
        del state, other
    return out


def life_time_text(t: dict) -> str:
    units = "".join(f"; {u} units a thread {ms:.6g} ms" for u, ms in t["ms_units"].items())
    return (f"{t['ms']:.6g} ms launch on the device ({t['kernels_a_call']} kernels{units}; "
            f"{t['ms_events']:.6g} ms by events around a loop; bound "
            f"{t['bound_ms']:.6g} ms, {t['bytes']} B); on the host's clock "
            f"{t['ms_call']:.6g} ms a call, {t['ms_stage']:.6g} ms its staging "
            f"(parts, ms: { {k: round(v, 5) for k, v in t['ms_stage_parts'].items()} }); "
            f"plain {t['plain_ms']:.6g} ms, index_copy {t['library_ms']:.6g} ms")


def life_edge_cases(diff: Diff, device) -> int:
    """The one-launch ops (``LIFE_ONE_PASS``) at the edge cases
    (``LIFE_EDGE_G`` x ``LIFE_EDGE_W``: word units, int4 units, one or
    four a thread), N in {0, 1, 7, 64, G}, unsorted batches, the rows on
    both sides of a bitmap word's edge, batch inputs as CUDA int32
    tensors in the caller's order, a staged call launched twice; each
    bit-equal to the
    plain version, one kernel a call, the input state unchanged and the
    untouched leaves the input's own; duplicate and out-of-range rows
    refused before any launch.  Returns the calls checked."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.ops import lifecycle as tl

    fns = {name: fn for name, fn, *_ in LIFE_KERNELS}
    calls = 0
    for G in LIFE_EDGE_G:
        for W in LIFE_EDGE_W:
            state = random_state(G, W, 700 + G + W, device)
            other = random_state(G, W, 800 + G + W, device)
            keep = [x.clone() for x in state]
            rng = np.random.default_rng(900 + G + W)
            edge = np.array([31, 32, 0, G - 1, 63, 64, 95])
            for name in LIFE_ONE_PASS:
                fn = fns[name]
                batches = [rng.choice(G, size=n, replace=False) for n in (0, 1, 7, 64, G)]
                batches.append(rng.permutation(edge))
                for bi, idx in enumerate(batches):
                    # restore_rows' rows: gathered on the card, or (even
                    # batches) copied to the host
                    args, kw = life_args(name, rng, G, W, len(idx), other,
                                         host_rows=bi % 2 == 0)
                    args = (idx,) + args[1:]
                    if bi % 2 and name != "gp_restore_rows":
                        # batch inputs on the card, in the caller's order
                        on = lambda x: torch.as_tensor(np.asarray(x).astype(np.int32),
                                                       device=device)
                        args = (idx,) + tuple(on(x) for x in args[1:])
                        kw = {k: on(v) if k != "my_id" else v for k, v in kw.items()}
                    tag = f"edge G{G} W{W} batch{bi} N{len(idx)}"
                    n0, k0 = te.LAUNCHES[name], te.KERNEL_LAUNCHES[name]
                    got = getattr(tl, fn)(state, *args, **kw)
                    want = getattr(tl, fn + "_plain")(state, *args, **kw)
                    diff.tree(name, tag, got, want)
                    diff.same(name, f"{tag}: kernels a call",
                              te.LAUNCHES[name] - n0 == 1 and te.KERNEL_LAUNCHES[name] - k0 == 1)
                    for f in te.EngineState._fields:
                        new, old = getattr(got, f), getattr(state, f)
                        diff.same(name, f"{tag}.{f}: fresh or shared leaf",
                                  (new is not old) == (f in gp_kernels.TOUCHED[name]))
                    st = gp_kernels.stage(name, state, *args, **kw)
                    st.launch()
                    st.launch()
                    diff.tree(name, f"{tag}.twice", st.result, want)
                    calls += 1
                for bad in (np.array([5, 9, 5]), np.array([0, G])):
                    args, kw = life_args(name, rng, G, W, len(bad), other)
                    n0 = te.LAUNCHES[name]
                    try:
                        getattr(tl, fn)(state, bad, *args[1:], **kw)
                        refused = False
                    except ValueError:
                        refused = True
                    diff.same(name, f"edge G{G} W{W}: bad rows {bad.tolist()} refused "
                              "before a launch", refused and te.LAUNCHES[name] == n0)
            torch.cuda.synchronize()
            for f, a, b in zip(te.EngineState._fields, state, keep):
                diff.eq("gp_create_groups", f"edge G{G} W{W}.input.{f}", a, b)
            del state, other, keep
    return calls


def phase_lifecycle(diff: Diff, device, bw: float) -> dict:
    """Every lifecycle kernel against its plain version on the card at
    every shape (module docstring), its kernels a call, the one-launch
    ops' edge cases, then its times at N=4,096 (the ledger's at its
    32,768-name chunk; the server shape's at N=1 too)."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.ops import lifecycle as tl

    fields = te.EngineState._fields
    t0 = time.perf_counter()
    times = {name: {"parity_launches": 0, "parity_kernels": 0} for name, *_ in LIFE_KERNELS}
    for si, (shape, (G, W, Ns)) in enumerate(LIFE_SHAPES.items()):
        te.reset_launch_counts()
        state = random_state(G, W, 400 + si, device)
        other = random_state(G, W, 500 + si, device)
        keep = [x.clone() for x in state]
        rng = np.random.default_rng(600 + si)
        for N in Ns:
            for name, fn, _ref, _path in LIFE_KERNELS:
                variants = [False, True] if name == "gp_restore_rows" and N == 7 else [False]
                for host_rows in variants:
                    args, kw = life_args(name, rng, G, W, N, other, host_rows)
                    k0 = te.KERNEL_LAUNCHES[name]
                    got = getattr(tl, fn)(state, *args, **kw)
                    want = getattr(tl, fn + "_plain")(state, *args, **kw)
                    tag = f"{shape}.N{N}" + (".host_rows" if host_rows else "")
                    k = te.KERNEL_LAUNCHES[name] - k0
                    diff.same(name, f"{tag}: {k} kernels a call",
                              k == life_kernels_a_call(name, N))
                    if name == "gp_extract_rows":
                        for f, a, b in zip(fields, got, want):
                            diff.eq(name, f"{tag}.{f}", a, b)
                    else:
                        diff.tree(name, tag, got, want)
                        ptrs = {x.data_ptr() for x in state}
                        for f in fields:
                            new, old = getattr(got, f), getattr(state, f)
                            if f in gp_kernels.TOUCHED[name]:
                                diff.same(name, f"{tag}.{f}: not a fresh tensor",
                                          new is not old and new.data_ptr() not in ptrs)
                            else:
                                diff.same(name, f"{tag}.{f}: untouched leaf replaced",
                                          new is old)
                    for f, a, b in zip(fields, state, keep):
                        diff.eq(name, f"{tag}.input.{f}", a, b)
                    del got, want
        # a bad row batch is refused before any launch; kill, which
        # writes constants only, takes a repeated row as the plain version
        # does
        for name, fn, _ref, _path in LIFE_KERNELS:
            args, kw = life_args(name, rng, G, W, 4, other)
            for bad in ([1, 2, 1, 3], [0, 1, 2, G]):
                call = lambda f: f(state, np.array(bad), *args[1:], **kw)
                if name == "gp_kill_groups" and bad[-1] < G:
                    diff.tree(name, f"{shape}.repeated_rows", call(tl.kill_groups),
                              call(tl.kill_groups_plain))
                    continue
                try:
                    call(getattr(tl, fn))
                    refused = False
                except ValueError:
                    refused = True
                diff.same(name, f"{shape}: bad rows {bad} not refused", refused)
        torch.cuda.synchronize()
        for name, *_ in LIFE_KERNELS:
            times[name]["parity_launches"] += te.LAUNCHES[name]
            times[name]["parity_kernels"] += te.KERNEL_LAUNCHES[name]
        # times at N=4,096 (the shape's largest batch if smaller, the
        # ledger's create chunk at its shape; the server shape at N=1 too)
        timed = [(shape, LIFE_TIMING_N_AT.get(shape, min(LIFE_TIMING_N, max(Ns))))]
        if shape in LIFE_TIMING_N_ALSO:
            n1 = LIFE_TIMING_N_ALSO[shape]
            timed.append((f"{shape}_n{n1}", n1))
        for label, n in timed:
            for name, fn, _ref, _path in LIFE_KERNELS:
                args, kw = life_args(name, rng, G, W, n, other)
                times[name][label] = time_life(name, fn, state, args, kw, G, W, n,
                                               device, bw)
                log(f"lifecycle {label} {name}: " + life_time_text(times[name][label]))
        del state, other, keep
        torch.cuda.empty_cache()
    log(f"lifecycle edge cases: {life_edge_cases(diff, device)} calls bit-equal")
    log(f"lifecycle parity: "
        f"{ {k: diff.checked[k] for k, *_ in LIFE_KERNELS} } checks bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")
    return times


# ---------------------------------------------------------------------------
# phase 2c: the gathered blobs' row pack
# ---------------------------------------------------------------------------


def pack_blobs(G: int, W: int, R: int, seed: int, device, fuzzed: bool):
    """R replicas' blobs as numpy leaves ``[R, ...]``: ``gp_make_blob`` of
    seeded random states (the words the cluster exchanges) or, fuzzed,
    random words over the full int32 range."""
    import numpy as np

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels

    rng = np.random.default_rng(seed)
    if fuzzed:
        gw = {"acc_vid", "dec_vid", "prop_vid", "lane_meta"}
        return te.Blob(**{
            f: rng.integers(-2 ** 31, 2 ** 31 - 1, size=(R, G, W) if f in gw else (R, G),
                            dtype=np.int64).astype(np.int32)
            for f in te.Blob._fields
        })
    rows = [te.split_blob_vec(te.to_host(gp_kernels.make_blob_vec(
        random_state(G, W, seed + r, device))), te.EngineConfig(G, W, 1, 1))
        for r in range(R)]
    return te.Blob(*(np.stack(leaves) for leaves in zip(*rows)))


def mixed_leaves(blob, device, pattern: str):
    """The same words with leaves on the card, in numpy or on the CPU,
    by ``pattern`` (one letter a leaf: d, n, c)."""
    import torch

    put = {"d": lambda v: torch.as_tensor(v, device=device),
           "n": lambda v: v, "c": lambda v: torch.as_tensor(v)}
    return type(blob)(*(put[k](v) for k, v in zip(pattern, blob)))


def phase_pack_rows(diff: Diff, device, bw: float) -> dict:
    """gp_pack_rows against pack_rows_plain, bit for bit, at every
    ``PACK_SHAPES`` shape on seeded and fuzzed blobs with the leaves in
    numpy (as the stepped cluster passes them), on the card and mixed;
    then its times: the launch alone on the device (a CUDA graph) and by
    events, the full call and its staging on the host's clock, the plain
    version (upload per leaf + ``torch.cat``) and ``torch.cat`` of leaves
    already on the card (the library call)."""
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels

    t0 = time.perf_counter()
    res = {}
    for si, (shape, (G, W, R)) in enumerate(PACK_SHAPES.items()):
        for fuzzed in (False, True):
            blob = pack_blobs(G, W, R, 700 + 10 * si, device, fuzzed)
            want = te.pack_rows_plain(blob, device)
            for pattern in ("nnnnnnnn", "dddddddd", "ndcndcnd", "cdndcdnc"):
                got = gp_kernels.pack_rows(mixed_leaves(blob, device, pattern), device)
                diff.eq("gp_pack_rows", f"{shape}.{'fuzzed' if fuzzed else 'seeded'}."
                        f"{pattern}", got, want)
            for r in range(R):   # each row is pack_blob of that replica
                one = te.Blob(*(torch.as_tensor(x[r], device=device) for x in blob))
                diff.eq("gp_pack_rows", f"{shape}.row{r}", want[r], te.pack_blob(one))
        on_card = mixed_leaves(blob, device, "dddddddd")
        staged = gp_kernels.StagedPack(blob, device)
        ms = graph_ms(staged.launch)
        ms_events = cuda_ms(staged.launch, TIMING_ITERS)
        ms_call = host_ms(lambda: gp_kernels.pack_rows(blob, device), TIMING_ITERS)
        ms_stage = host_ms(lambda: gp_kernels.StagedPack(blob, device), TIMING_ITERS)
        plain_ms = host_ms(lambda: te.pack_rows_plain(blob, device), TIMING_ITERS)
        cat = lambda: torch.cat([x.reshape(R, -1) for x in on_card], dim=1)
        library_ms = graph_ms(cat)
        # at the small shapes both sit near the launch floor: time them in
        # turns, kernel then torch.cat, PACK_TURNS times
        turns = [(graph_ms(staged.launch), graph_ms(cat))
                 for _ in range(PACK_TURNS if G * R <= 4096 else 0)]
        nbytes = pack_bytes(G, W, R)
        res[shape] = {
            "G": G, "W": W, "R": R, "ms": ms, "ms_events": ms_events,
            "ms_call": ms_call, "ms_stage": ms_stage, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": nbytes,
            "bound_ms": nbytes / bw * 1e3, "turns_ms_kernel_cat": turns,
        }
        log(f"pack_rows {shape} (G={G}, W={W}, R={R}): {ms:.6g} ms launch on the "
            f"device ({ms_events:.6g} ms by events; bound {nbytes / bw * 1e3:.6g} ms, "
            f"{nbytes} B); on the host's clock {ms_call:.6g} ms a call, "
            f"{ms_stage:.6g} ms its staging; plain {plain_ms:.6g} ms, torch.cat "
            f"of card-resident leaves {library_ms:.6g} ms")
        if turns:
            log(f"pack_rows {shape} in turns (kernel, torch.cat) ms: "
                + ", ".join(f"({a:.6g}, {b:.6g})" for a, b in turns))
        del staged, blob, want, on_card
        torch.cuda.empty_cache()
    log(f"pack_rows parity: {diff.checked['gp_pack_rows']} checks bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# phase 4: group density; phase 5: state transfer
# ---------------------------------------------------------------------------


def phase_density(device) -> dict:
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.density import DensityCheckFailed, run_density

    with tempfile.TemporaryDirectory(prefix="gp_density_") as d:
        te.reset_launch_counts()
        try:
            res = run_density(**DENSITY, device=device, log_dir=d,
                              progress=lambda m: log(f"density: {m}"))
        except DensityCheckFailed as e:
            fail(f"density: {e}")
        launches = dict(te.LAUNCHES)
        kernel_launches = dict(te.KERNEL_LAUNCHES)
    for name in ("gp_create_groups", "gp_kill_groups", "gp_restore_paused_rows",
                 "gp_step", "gp_make_blob"):
        if launches[name] <= 0:
            fail(f"density: {name} never launched: {launches}")
    res["launches_total"] = launches
    res["kernel_launches_total"] = kernel_launches
    ab, ch, bo = res["ablation"], res["churn"], res["boot"]
    log(f"density: {res['names']} names on {res['rows']} rows: boot "
        f"{bo['names_per_s']:.6g} names/s, host {res['bytes_per_name']['host_rss']:.6g} "
        f"B/name; wake per-name {ab['per_name_us']:.6g} us/name vs batched "
        f"{ab['batched_us_per_name']:.6g} us/name ({ab['speedup_per_name']:.6g}x); "
        f"churn {ch['replies']}/{ch['requests']} answered, {ch['req_per_s']:.6g} "
        f"req/s, wake p50 {ch['wake_p50_s']} s p99 {ch['wake_p99_s']} s; "
        f"residency {res['residency_end']}; launches {res['launches']}")
    return res


def phase_state_transfer(device) -> dict:
    import numpy as np

    from gigapaxos_tpu_torch.manager import PaxosManager
    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.cluster import DELIVER, DROP, ManagerCluster
    from gigapaxos_tpu_torch.utils.config import Config

    G, W, K, R = (SERVER[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)

    def until_executed(c, vals, entry, delivery=None, max_steps=60):
        done = {}
        for v in vals:
            c.managers[entry].propose(
                name, v, callback=lambda r, resp: done.setdefault(r, resp))
        for _ in range(max_steps):
            if len(done) == len(vals):
                return
            c.step_all(delivery=delivery)
        fail(f"state transfer: {len(done)}/{len(vals)} executed")

    # this scenario drives the frontier by slot COUNT: coalescing would
    # pack each burst into about two slots
    Config.set("BATCHING_ENABLED", "false")
    c = None
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="gp_state_transfer_") as d:
            dirs = [os.path.join(d, f"n{i}") for i in range(R)]
            te.reset_launch_counts()
            c = ManagerCluster(cfg, HashChainApp, log_dirs=dirs, device=device)
            # a stepped cluster's failure detector never fires, so the
            # replica that dies must not coordinate the name: take the
            # first name whose row's initial coordinator is replica 0
            name = next(nm for nm in (f"svc{i}" for i in range(64))
                        if c.managers[0].default_row_for(nm) % R == 0)
            c.create(name, members=list(range(R)))
            row = c.managers[0].names[name]
            until_executed(c, [f"a{i}" for i in range(4)], 0)
            c.managers[2].close()
            dead = np.full((R, R), DELIVER)
            dead[2, :] = DROP
            dead[:, 2] = DROP
            for b in range(ST_BATCHES):
                until_executed(c, [f"b{b}-{i}" for i in range(ST_BATCH_REQS)], 0,
                               delivery=dead)
            live = int(c.managers[0]._np("exec_slot")[row])
            behind = int(c.managers[2]._np("exec_slot")[row])
            if live - behind <= 5 * W:
                fail(f"state transfer: straggler only {live - behind} slots behind")
            c.managers[2] = PaxosManager(2, HashChainApp(), cfg, log_dir=dirs[2],
                                         device=device)
            c.blobs[2] = c.managers[2].blob()
            steps = 0
            for steps in range(1, 81):
                c.step_all()
                if int(c.managers[2]._np("exec_slot")[row]) >= live:
                    break
            until_executed(c, ["post-1", "post-2"], 2)
            for _ in range(5):   # let every replica execute them
                c.step_all()
            launches = dict(te.LAUNCHES)
            kernel_launches = dict(te.KERNEL_LAUNCHES)
            hashes = [int(m._np("app_hash")[row]) for m in c.managers]
            states = [m.app.state.get(name) for m in c.managers]
            n_exec = [m.app.n_executed.get(name) for m in c.managers]
            for m in c.managers:
                m.close()
            c = None
    finally:
        Config._cli.pop("BATCHING_ENABLED", None)
        if c is not None:
            for m in c.managers:
                m.close()
    if launches["gp_jump_rows"] < 1:
        fail(f"state transfer: gp_jump_rows never launched: {launches}")
    if kernel_launches["gp_jump_rows"] != launches["gp_jump_rows"]:
        fail(f"state transfer: gp_jump_rows not one kernel a call: "
             f"{kernel_launches['gp_jump_rows']} kernels, {launches['gp_jump_rows']} calls")
    if len(set(hashes)) != 1 or len(set(states)) != 1 or len(set(n_exec)) != 1:
        fail(f"state transfer: replicas disagree: hashes {hashes}, executed {n_exec}")
    res = {"gap_slots": live - behind, "rejoin_steps": steps, "launches": launches,
           "executed": n_exec[0], "seconds": time.perf_counter() - t0}
    log(f"state transfer: straggler {live - behind} slots behind rejoined in "
        f"{steps} steps; {n_exec[0]} executed on all 3, equal hash chains; "
        f"launches {launches} ({res['seconds']:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# phase 7: the stepped reconfiguration harness; phase 8: the socket
# deployment of the reconfiguration layer
# ---------------------------------------------------------------------------


def rc_run_requests(c, name, values, entry) -> dict:
    """Propose ``values`` at active ``entry`` and step until all executed."""
    done = {}
    mgr = c.ars.managers[entry]
    for v in values:
        mgr.propose(name, v, callback=lambda rid, resp: done.setdefault(rid, resp))
    for _ in range(40):
        if len(done) == len(values):
            return done
        c.step()
    fail(f"rc_stepped: only {len(done)}/{len(values)} of {name}'s requests executed")


def phase_rc_stepped(device) -> dict:
    """``ReconfigurableCluster`` on the card at the actives' and the
    reconfigurators' shapes (``AR``, ``RC``): the create -> request ->
    migrate -> delete -> re-create script of the JAX package's
    ``tests/test_reconfiguration.py:80``, then its migration under a
    seeded 30% loss of reconfiguration-plane messages (``:237``).  Every
    manager's tick packs its gathered blobs with ``gp_pack_rows``."""
    import numpy as np

    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.reconfiguration import active_replica as ar_mod
    from gigapaxos_tpu_torch.reconfiguration import reconfigurator as rc_mod
    from gigapaxos_tpu_torch.testing.rc_cluster import ReconfigurableCluster

    ar_cfg = te.EngineConfig(*(AR[k] for k in ("G", "W", "K", "R")))
    rc_cfg = te.EngineConfig(*(RC[k] for k in ("G", "W", "K", "R")))

    def ack_of(c, kind, what, max_steps=120):
        ack = c.wait_for(kind, max_steps=max_steps)
        if not ack or not ack.get("ok"):
            fail(f"rc_stepped: {what}: {ack}")
        return ack

    te.reset_launch_counts()
    t0 = time.perf_counter()
    c = ReconfigurableCluster(ar_cfg, rc_cfg, HashChainApp, device=device)
    # each cluster step ticks every manager once
    ticks = lambda c: sum(m._tick_no for m in c.ars.managers + c.rcs.managers)
    try:
        c.client_request("create_service", {"name": "svc", "actives": [0, 1, 2]}, rc=0)
        ack = ack_of(c, "create_ack", "create")
        if sorted(ack["actives"]) != [0, 1, 2] or ack["epoch"] != 0:
            fail(f"rc_stepped: create acked {ack}")
        c.client_request("request_actives", {"name": "svc"}, rc=1)
        if sorted(ack_of(c, "actives_response", "request_actives")["actives"]) != [0, 1, 2]:
            fail("rc_stepped: request_actives")
        rc_run_requests(c, "svc", [f"r{i}" for i in range(5)], 0)
        apps = [m.app for m in c.ars.managers]
        if not apps[0].state["svc"] == apps[1].state["svc"] == apps[2].state["svc"] \
                or "svc" in apps[3].state:
            fail("rc_stepped: epoch 0 states disagree")
        c.client_request("reconfigure", {"name": "svc", "new_actives": [1, 2, 3]})
        ack = ack_of(c, "reconfigure_ack", "reconfigure")
        if sorted(ack["actives"]) != [1, 2, 3] or ack["epoch"] != 1:
            fail(f"rc_stepped: reconfigure acked {ack}")
        c.run(30)
        n1 = apps[1].n_executed["svc"]
        if not apps[3].state["svc"] == apps[1].state["svc"] == apps[2].state["svc"]:
            fail("rc_stepped: the new epoch did not resume from the final state")
        if c.ars.managers[0].names.get("svc") is not None or c.ars.managers[1].old_epochs:
            fail("rc_stepped: the old epoch was not dropped")
        rc_run_requests(c, "svc", [f"s{i}" for i in range(4)], 1)
        if apps[1].n_executed["svc"] != n1 + 4 or apps[3].state["svc"] != apps[1].state["svc"]:
            fail("rc_stepped: epoch 1 requests")
        c.client_request("delete_service", {"name": "svc"})
        ack_of(c, "delete_ack", "delete")
        c.run(5)
        if any(c.ars.managers[i].names.get("svc") is not None for i in (1, 2, 3)) \
                or any(r.rc_app.get_record("svc") is not None for r in c.reconfigurators):
            fail("rc_stepped: delete left a row or a record")
        c.client_request("create_service", {"name": "svc", "actives": [0, 2, 3]})
        if sorted(ack_of(c, "create_ack", "re-create")["actives"]) != [0, 2, 3]:
            fail("rc_stepped: re-create")
        steps_script, ticks_script = c.ars.managers[0]._tick_no, ticks(c)
    finally:
        c.close()
    t_script = time.perf_counter() - t0

    # the migration under a lossy reconfiguration plane, with fast
    # retransmits (as the reference test sets them)
    classes = (rc_mod.StartEpochTask, rc_mod.StopEpochTask, rc_mod.DropEpochTask,
               rc_mod.EpochCommitTask, rc_mod.LateStartTask, ar_mod.WaitEpochFinalState)
    saved = [cls.__dict__.get("restart_period_s") for cls in classes]
    for cls in classes:
        cls.restart_period_s = 0.02
    t1 = time.perf_counter()
    c = ReconfigurableCluster(ar_cfg, rc_cfg, HashChainApp, device=device)
    try:
        for rc in c.reconfigurators:
            rc.echo_probe_period_s = 0.0
        rng = np.random.RandomState(7)
        c.msg_filter = lambda dst, kind, body: rng.rand() > 0.3

        def request_with_retry(kind, body, ack_kind, max_steps=60):
            for _ in range(8):
                c.client_request(kind, dict(body))
                ack = c.wait_for(ack_kind, max_steps=max_steps)
                if ack is not None:
                    return ack
            return None

        ack = request_with_retry("create_service", {"name": "lossy", "actives": [0, 1, 2]},
                                 "create_ack")
        if not ack or not ack["ok"]:
            fail(f"rc_stepped: lossy create: {ack}")
        rc_run_requests(c, "lossy", ["a", "b", "c"], 1)
        ack = request_with_retry("reconfigure", {"name": "lossy", "new_actives": [1, 2, 3]},
                                 "reconfigure_ack", max_steps=100)
        if not ack or not ack["ok"]:
            fail(f"rc_stepped: lossy reconfigure: {ack}")
        c.run(20)
        apps = [m.app for m in c.ars.managers]
        if apps[3].state["lossy"] != apps[1].state["lossy"]:
            fail("rc_stepped: lossy migration diverged")
        steps_lossy, ticks_lossy = c.ars.managers[0]._tick_no, ticks(c)
    finally:
        c.close()
        for cls, v in zip(classes, saved):
            if v is None:
                del cls.restart_period_s
            else:
                cls.restart_period_s = v
    launches = dict(te.LAUNCHES)
    for k in ("gp_pack_rows", "gp_step", "gp_create_groups", "gp_kill_groups"):
        if launches[k] <= 0:
            fail(f"rc_stepped: {k} never launched: {launches}")
    if launches["gp_pack_rows"] != ticks_script + ticks_lossy:
        fail(f"rc_stepped: {launches['gp_pack_rows']} gp_pack_rows launches in "
             f"{ticks_script + ticks_lossy} manager ticks")
    res = {"steps_script": steps_script, "seconds_script": t_script,
           "steps_lossy": steps_lossy,
           "seconds_lossy": time.perf_counter() - t1, "launches": launches,
           "ar": AR, "rc": RC}
    log(f"rc_stepped: create/request/migrate/delete/re-create in "
        f"{steps_script} steps ({t_script:.4f} s, "
        f"{t_script / max(steps_script, 1) * 1e3:.6g} ms a step), lossy "
        f"migration in {res['steps_lossy']} steps ({res['seconds_lossy']:.4f} s); "
        f"launches {launches}")
    return res


def pct(xs, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q)) if len(xs) else float("nan")


def phase_reconfiguration(device) -> dict:
    """The socket deployment: ``ReconfigurableNode`` AR0..AR3 and
    RC0..RC2 in this process on loopback ports, configured by properties
    alone (their own defaults: the actives' engine ENGINE_ROWS x
    SLOT_WINDOW with K=8 and R=4, the reconfigurators' 64 rows; the card
    is the default device), ``HashChainApp``, and
    ``ReconfigurableAppClient.from_properties()``: batched and single
    creates, requests, migrations with a stale-cache request each, and
    deletes, each checked."""
    import hashlib

    import numpy as np

    from gigapaxos_tpu_torch.clients.reconfigurable_client import ReconfigurableAppClient
    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.paxos_config import PC
    from gigapaxos_tpu_torch.reconfigurable_node import ReconfigurableNode
    from gigapaxos_tpu_torch.utils.config import Config
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

    n_ar, n_rc = AR["R"], RC["R"]
    ports = node_ports(n_ar + n_rc, (0, Config.get_int(PC.HTTP_PORT_OFFSET)))
    for i in range(n_ar):
        Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
    for i in range(n_rc):
        Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[n_ar + i]}")
    te.reset_launch_counts()
    DelayProfiler.clear()
    nodes = ([ReconfigurableNode(f"AR{i}", HashChainApp) for i in range(n_ar)]
             + [ReconfigurableNode(f"RC{i}", HashChainApp) for i in range(n_rc)])
    ars = [n.servers[0] for n in nodes[:n_ar]]
    rcs = [n.servers[0] for n in nodes[n_ar:]]
    shapes = {"ar": tuple(ars[0].cfg), "rc": tuple(rcs[0].cfg)}
    if shapes != {"ar": tuple(AR[k] for k in "GWKR"), "rc": tuple(RC[k] for k in "GWKR")} \
            or ars[0].manager.device.type != "cuda":
        fail(f"reconfiguration: the nodes' defaults gave {shapes} on "
             f"{ars[0].manager.device}")
    client = None
    t_phase = time.perf_counter()
    step_log = lambda what: log(f"reconfiguration: [{time.perf_counter() - t_phase:.1f} s] "
                                f"{what}")
    try:
        for n in nodes:
            n.start()
        client = ReconfigurableAppClient.from_properties()

        # 1. a batch of creates, split per reconfigurator group
        batch = [f"rcn{i}" for i in range(RC_BATCH_NAMES)]
        t0 = time.perf_counter()
        results = client.create_names(batch, timeout=240)
        t_batch = time.perf_counter() - t0
        step_log(f"{len(batch)} batched creates in {t_batch:.4f} s")
        bad = [n for n in batch if not (results.get(n) or {}).get("ok")]
        if bad:
            fail(f"reconfiguration: {len(bad)} of {len(batch)} batched creates "
                 f"failed, first {bad[0]}: {results.get(bad[0])}")
        # 2. single creates, one at a time
        lat_create = []
        for i in range(RC_SINGLE_NAMES):
            t0 = time.perf_counter()
            ack = client.create_name(f"one{i}", timeout=60)
            if ack and not ack.get("ok") and ack.get("reason") == "exists":
                # the client's own retransmit found its first attempt's
                # record still in flight (the client confirms by resolving
                # the name, which is not yet possible): success once the
                # name resolves
                deadline = time.time() + 60
                while time.time() < deadline:
                    acts = client.request_actives(f"one{i}", timeout=10, force=True)
                    if acts:
                        ack = {"name": f"one{i}", "ok": True, "actives": acts,
                               "existed": True}
                        break
                    time.sleep(0.25)
            lat_create.append(time.perf_counter() - t0)
            if not ack or not ack.get("ok"):
                fail(f"reconfiguration: create one{i}: {ack}")
        step_log(f"{RC_SINGLE_NAMES} single creates")
        # 3. requests: RC_REQS_PER_NAME in sequence on each of RC_REQ_NAMES
        # names, the names in parallel; every response is the next link of
        # the name's hash chain
        req_names = batch[:RC_REQ_NAMES]
        chains = {nm: "" for nm in req_names}
        lat_req, errors = [], []
        lock = threading.Lock()

        def chain(nm: str, tag: str, n: int) -> None:
            h = chains[nm]
            for k in range(n):
                v = f"{tag}{k}"
                t0 = time.perf_counter()
                resp = client.send_request_sync(nm, v, timeout=120)
                dt = time.perf_counter() - t0
                h = hashlib.sha256((h + v).encode("utf-8")).hexdigest()
                with lock:
                    lat_req.append(dt)
                    if resp != h[:16]:
                        errors.append((nm, v, resp, h[:16]))
            chains[nm] = h

        def run_threads(target, items, *args) -> float:
            threads = [threading.Thread(target=target, args=(it, *args)) for it in items]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return time.perf_counter() - t0

        wall_req = run_threads(chain, req_names, "q", RC_REQS_PER_NAME)
        lat_main = list(lat_req)   # the stale-cache requests below are apart
        step_log(f"{len(lat_main)} requests in {wall_req:.4f} s")
        if errors:
            fail(f"reconfiguration: {len(errors)} wrong responses, first {errors[0]}")
        actives = {}
        for nm in req_names:
            acts = client.request_actives(nm, timeout=30, force=True)
            if not acts:
                fail(f"reconfiguration: {nm} did not resolve")
            actives[nm] = sorted(acts)

        def converged(names, what):
            deadline = time.time() + 60
            while time.time() < deadline:
                if all(ars[a].manager.app.state.get(nm) == chains[nm]
                       for nm in names for a in actives[nm]):
                    return
                time.sleep(0.1)
            bad = [(nm, a) for nm in names for a in actives[nm]
                   if ars[a].manager.app.state.get(nm) != chains[nm]]
            fail(f"reconfiguration: {what}: {len(bad)} members' states differ, "
                 f"first {bad[0]}")

        converged(req_names, "after the requests")
        step_log("members converged")
        # 4. migrations onto a set with an active outside the current one
        moved = req_names[:RC_MOVES]
        lat_move, move_errors = [], []

        def move(nm: str) -> None:
            old = actives[nm]
            outside = [a for a in range(n_ar) if a not in old][0]
            new = sorted(old[1:] + [outside])
            t0 = time.perf_counter()
            ack = client.reconfigure(nm, new, timeout=240)
            dt = time.perf_counter() - t0
            with lock:
                lat_move.append(dt)
                if not ack or not ack.get("ok") or sorted(ack["actives"]) != new:
                    move_errors.append((nm, new, ack))
            actives[nm + "/departed"] = [old[0]]
            actives[nm] = new
            if ack and ack.get("ok"):
                # the old epoch's final stop request executes on the app
                # too: the chain carries its value
                stop = json.dumps({"__stop__": int(ack["epoch"]) - 1})
                chains[nm] = hashlib.sha256((chains[nm] + stop).encode("utf-8")).hexdigest()

        wall_move = run_threads(move, moved)
        step_log(f"{len(moved)} migrations in {wall_move:.4f} s")
        if move_errors:
            fail(f"reconfiguration: {len(move_errors)} migrations failed, first "
                 f"{move_errors[0]}")
        for nm in moved:   # the departed active forgets the name
            gone = actives[nm + "/departed"][0]
            deadline = time.time() + 60
            while ars[gone].manager.names.get(nm) is not None and time.time() < deadline:
                time.sleep(0.1)
            if ars[gone].manager.names.get(nm) is not None:
                fail(f"reconfiguration: AR{gone} still hosts {nm} after the migration")
        # a request per name from a stale actives cache (the departed
        # active): unknown name -> re-resolve -> the new epoch answers
        for nm in moved:
            with client._lock:
                client._actives_cache[nm] = (time.time() + 60, actives[nm + "/departed"])
        run_threads(chain, moved, "m", 1)
        if errors:
            fail(f"reconfiguration: a stale-cache request was answered wrong: {errors[0]}")
        converged(moved, "after the migrations")
        step_log("stale-cache requests answered, members converged")
        # 5. deletes
        lat_delete, del_errors = [], []

        def delete(nm: str) -> None:
            t0 = time.perf_counter()
            ack = client.delete_name(nm, timeout=240)
            with lock:
                lat_delete.append(time.perf_counter() - t0)
                if not ack or not ack.get("ok"):
                    del_errors.append((nm, ack))

        deleted = moved[:RC_DELETES]
        wall_delete = run_threads(delete, deleted)
        step_log(f"{len(deleted)} deletes in {wall_delete:.4f} s")
        if del_errors:
            fail(f"reconfiguration: {len(del_errors)} deletes failed, first {del_errors[0]}")
        def hosted():
            out = [(nm, f"AR{i}") for nm in deleted for i in range(n_ar)
                   if ars[i].manager.names.get(nm) is not None]
            return out + [(nm, f"RC{j}") for nm in deleted for j in range(n_rc)
                          if rcs[j].rc_app.get_record(nm) is not None]

        def where(nm, at):
            if at.startswith("RC"):
                return (nm, at, rcs[int(at[2:])].rc_app.get_record(nm).to_json())
            m = ars[int(at[2:])].manager
            row = m.names.get(nm)
            return (nm, at, row, m.current_epoch(nm), m.is_stopped(nm),
                    row in m.pending_rows, int(m._np("exec_slot")[row]),
                    int(m._np("member_mask")[row]),
                    [int(a.manager._np("exec_slot")[row]) for a in ars])

        # a member that had not executed the epoch's stop when its peers
        # dropped the group is freed by the active replica's stranded-row
        # probe, which runs once a deactivation period
        patience = 3 * Config.get_float(PC.DEACTIVATION_PERIOD_S)
        t_del = time.perf_counter()
        left, shown = hosted(), 0.0
        while left and time.perf_counter() - t_del < patience:
            if time.perf_counter() - t_del >= shown:
                step_log(f"{len(left)} (name, node) still hosting a deleted name: "
                         f"{[where(nm, at) for nm, at in left[:3]]}")
                shown += 20.0
            time.sleep(0.5)
            left = hosted()
        if left:
            fail(f"reconfiguration: deleted names still hosted after {patience} s: "
                 f"{[where(nm, at) for nm, at in left[:4]]}")
        t_freed = time.perf_counter() - t_del
        step_log(f"every deleted name freed on every member {t_freed:.4f} s after "
                 f"the last delete ack")
        launches = dict(te.LAUNCHES)
        for k in ("gp_step", "gp_make_blob", "gp_create_groups", "gp_kill_groups"):
            if launches[k] <= 0:
                fail(f"reconfiguration: {k} never launched: {launches}")
        roles = {}
        for role, servers in (("active", ars), ("reconfigurator", rcs)):
            roles[role] = [
                {"ticks": s._tick, "sent": s.transport.n_sent,
                 "rcvd": s.transport.n_rcvd, "dropped": s.transport.n_dropped,
                 "engine_step_s": s.manager.last_engine_step_s,
                 "launches": dict(s.manager.kernel_launches)}
                for s in servers
            ]
        n_req = len(lat_main)
        res = {
            "names_batch": len(batch), "batch_seconds": t_batch,
            "creates_per_s": len(batch) / t_batch,
            "create_p50_ms": pct(lat_create, 50), "create_p99_ms": pct(lat_create, 99),
            "requests": n_req, "req_per_s": RC_REQ_NAMES * RC_REQS_PER_NAME / wall_req,
            "req_p50_ms": pct(lat_main, 50), "req_p99_ms": pct(lat_main, 99),
            "moves": len(moved), "move_p50_ms": pct(lat_move, 50),
            "move_p99_ms": pct(lat_move, 99), "move_wall_s": wall_move,
            "deletes": len(deleted), "delete_p50_ms": pct(lat_delete, 50),
            "delete_p99_ms": pct(lat_delete, 99), "delete_wall_s": wall_delete,
            "freed_after_delete_s": t_freed,
            "launches": launches, "roles": roles, "ar": AR, "rc": RC,
            "seconds": time.perf_counter() - t_phase,
        }
        for role, per in roles.items():
            log(f"reconfiguration {role}s: {per}")
        log(f"reconfiguration: DelayProfiler (this process, every role) "
            f"{DelayProfiler.get_stats()}")
        log(f"reconfiguration: {len(batch)} batched creates in {t_batch:.4f} s "
            f"({res['creates_per_s']:.6g} creates/s); {RC_SINGLE_NAMES} single creates "
            f"p50 {res['create_p50_ms']:.6g} ms p99 {res['create_p99_ms']:.6g} ms; "
            f"{n_req} requests (+{len(moved)} stale-cache) over {RC_REQ_NAMES} names "
            f"correct, {res['req_per_s']:.6g} req/s, p50 {res['req_p50_ms']:.6g} ms "
            f"p99 {res['req_p99_ms']:.6g} ms; {len(moved)} migrations in parallel "
            f"p50 {res['move_p50_ms']:.6g} ms p99 {res['move_p99_ms']:.6g} ms; "
            f"{len(deleted)} deletes p50 {res['delete_p50_ms']:.6g} ms p99 "
            f"{res['delete_p99_ms']:.6g} ms; launches {launches} "
            f"({res['seconds']:.1f} s)")
        return res
    finally:
        if client is not None:
            client.close()
        for n in nodes:
            n.stop()
        Config.clear()


# ---------------------------------------------------------------------------
# phase 3: the headline engine (stacked face)
# ---------------------------------------------------------------------------


def assert_rsm(states) -> int:
    """Equal app hash wherever frontiers are equal, every replica pair;
    returns the number of (group, pair) cells with equal frontiers."""
    R = states.exec_slot.shape[0]
    cells = 0
    for a in range(R):
        for b in range(a + 1, R):
            same = states.exec_slot[a] == states.exec_slot[b]
            bad = same & (states.app_hash[a] != states.app_hash[b])
            if bool(bad.any()):
                fail(f"RSM divergence between replicas {a} and {b}")
            cells += int(same.sum())
    return cells


def phase_headline(diff: Diff, device, bw: float, results: str) -> dict:
    """The bench's headline arms through ``testing/bench.py`` (its load,
    warm-up and timed chunks), each with the plain version beside the
    kernel at full width after the warm-up; then gp_step's times at this
    shape; then the bench's capacity arm and its dispatch ablation.  The
    steady arm's bench line and the ablation's result go to ``results``
    (the baseline phase folds them)."""
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states
    from gigapaxos_tpu_torch.testing import bench

    G, W, K, R = (HEADLINE[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)

    def plain_beside(arm):
        def hook(load, t):
            # full-width parity: the plain version beside the kernel
            snap = te.EngineState(*(x.clone() for x in load.states))
            for j in range(HEADLINE_PLAIN_STEPS):
                k_st, k_o = load.step_fn(
                    te.EngineState(*(x.clone() for x in snap)), load.req, load.want(t + j))
                p_st, p_o = load.step_fn.plain(snap, load.req, load.want(t + j))
                diff.tree("gp_step", f"headline.{arm}.{j}.state", k_st, p_st)
                diff.tree("gp_step", f"headline.{arm}.{j}.out", k_o, p_o)
                snap = p_st
                del k_st, k_o, p_o
            del snap, p_st
            torch.cuda.synchronize()
            # main path: counts from 0 just before the timed chunks
            te.reset_launch_counts()
        return hook

    arms = {}
    torch.cuda.reset_peak_memory_stats()
    for arm in ("steady", "failover"):
        res = bench.run_headline(G, W, K, device, failover=arm == "failover",
                                 after_warmup=plain_beside(arm))
        launches = dict(te.LAUNCHES)
        # the stacked face at N = 1: one gp_step launch a step, no blob launch
        if launches["gp_step"] < res["steps"] or launches["gp_make_blob"]:
            fail(f"headline {arm}: main path launched {launches}")
        if res["total"] <= 0:
            fail(f"headline {arm}: no decisions committed")
        cells = assert_rsm(res["states"])
        line = bench.headline_result(res, G, device, arm == "failover")
        arms[arm] = {
            "dec_per_s": res["rate"], "steps": res["steps"], "seconds": res["steady_s"],
            "warmup_s": res["warmup_s"], "launches": launches,
            "rsm_equal_frontier_cells": cells, "bench_line": line,
        }
        log(f"headline {arm}: {res['rate']:.6g} committed decisions/s over "
            f"{res['steps']} steps ({res['steady_s']:.4f} s, warm-up "
            f"{res['warmup_s']:.4f} s), launches {launches}, RSM ok on {cells} "
            f"equal-frontier cells; bench line {json.dumps(line)}")
        del res
    bench.write_out(os.path.join(results, "headline.json"), arms["steady"]["bench_line"])
    peak = torch.cuda.max_memory_allocated()
    # kernel timing at this shape: one stacked gp_step launch = R
    # replica-steps; one gp_make_blob launch over R replicas
    load = bench.StackedLoad(cfg, device)
    step_fn, req, no_want = load.step_fn, load.req, load.no_want
    load.chunk(0, bench.WARM_CHUNKS * bench.CHUNK)
    states = load.states
    blobs = gp_kernels.make_blob_rows(states, R)
    hm = torch.ones((R, R), dtype=torch.bool, device=device)
    out_st = te.EngineState(*(torch.empty_like(x) for x in states))
    out_mat = torch.empty((R, te.out_vec_len(cfg)), dtype=torch.int32, device=device)
    out_bl = torch.empty_like(blobs)
    plan = gp_kernels.step_launch_plan(cfg, stacked=True)
    launch = lambda: gp_kernels.step_stacked(
        states, blobs, hm, req, no_want, cfg, out_states=out_st,
        out_mat=out_mat, out_blobs=out_bl)
    # on the device (a CUDA graph of launches), and by events around a loop
    ms_step = graph_ms(launch, calls=5, reps=4) / R
    ms_events = cuda_ms(launch, TIMING_ITERS) / R
    # the same launch with the wrapper allocating the new states (what
    # make_step does): the caching allocator's cost per step
    ms_fresh = cuda_ms(lambda: gp_kernels.step_stacked(
        states, blobs, hm, req, no_want, cfg,
        out_mat=out_mat, out_blobs=out_bl), TIMING_ITERS) / R
    ms_blob = cuda_ms(lambda: gp_kernels.make_blob_rows(states, R),
                      TIMING_ITERS) / R
    plain_ms = cuda_ms(lambda: step_fn.plain(states, req, no_want), 2) / R
    # the route the stacked face takes at N = 1 (one gp_step_tile launch),
    # and the chain its app-hash fold runs: the mean n_committed of a
    # member (replica, group) step of this state
    tile_step = lambda: gp_kernels.step_stacked(
        states, None, hm, req, no_want, cfg, out_states=out_st, out_mat=out_mat)
    ms_tile = graph_ms(tile_step, calls=5, reps=4) / R
    # the route as the face takes it: each launch on the state the last
    # returned, into fresh states, without and with the quiescence flags
    # (this steady traffic leaves no tile quiet: the flags' cost alone)
    walk = [states, states]

    def tile_walk(i, flags):
        walk[i], _, _ = gp_kernels.step_stacked(walk[i], None, hm, req, no_want, cfg,
                                                out_mat=out_mat, flags=flags)

    tile_flags = gp_kernels.TileFlags(cfg, device)
    ms_tile_walk = cuda_ms(lambda: tile_walk(0, None), TIMING_ITERS) / R
    ms_tile_flags = cuda_ms(lambda: tile_walk(1, tile_flags), TIMING_ITERS) / R
    del walk, tile_flags
    tile_step()
    member = (states.member_mask >> torch.arange(R, device=device)[:, None]) & 1 == 1
    n_comm = te.unpack_out(out_mat, cfg).n_committed
    fold_chain = float(n_comm[member].double().mean()) if bool(member.any()) else 0.0
    # a quiet state beside the steady one: 20 steps with no request
    # offered, so nothing is decided or admitted and the execute and
    # admission rounds have nothing to take
    no_req = torch.full_like(req, -1)
    quiet = build_replica_states(cfg, device=device)
    for _ in range(bench.WARM_CHUNKS * bench.CHUNK):
        quiet, _ = step_fn(quiet, no_req, no_want)
    q_blobs = gp_kernels.make_blob_rows(quiet, R)
    ms_quiet = graph_ms(lambda: gp_kernels.step_stacked(
        quiet, q_blobs, hm, no_req, no_want, cfg, out_states=out_st,
        out_mat=out_mat, out_blobs=out_bl), calls=5, reps=4) / R
    # the quiet state on the tile route, walked with the flags: its tiles
    # copied through
    q_walk, q_flags = [quiet], gp_kernels.TileFlags(cfg, device)

    def quiet_walk():
        q_walk[0], _, _ = gp_kernels.step_stacked(q_walk[0], None, hm, no_req, no_want, cfg,
                                                  out_mat=out_mat, flags=q_flags)

    quiet_walk()
    torch.cuda.synchronize()
    gp_kernels.reset_tile_counts()
    ms_quiet_tile = cuda_ms(quiet_walk, TIMING_ITERS) / R
    quiet_tiles = gp_kernels.tile_counts()
    del quiet, q_blobs, q_walk, q_flags
    nbytes = stacked_step_bytes(G, W, K, R)
    bound = nbytes / bw * 1e3
    log(f"headline gp_step: {ms_step:.6g} ms per replica-step on the device "
        f"into preallocated states, {100 * bound / ms_step:.4g}% of the bound "
        f"({ms_events:.6g} ms by events, {ms_fresh:.6g} ms into fresh ones; "
        f"quiet state {ms_quiet:.6g} ms); bound {bound:.6g} ms ({nbytes} B per "
        f"replica-step at {bw:.3g} B/s), plain {plain_ms:.6g} ms; plan "
        f"{plan_str(plan)}; peak device memory {peak} B")
    log(f"headline gp_step_tile: {ms_tile:.6g} ms per replica-step on the device, "
        f"{100 * bound / ms_tile:.4g}% of the bound; mean n_committed a member "
        f"(replica, group) step {fold_chain:.6g} (the hash fold's chain); walked "
        f"into fresh states by events {ms_tile_walk:.6g} ms, with the quiescence "
        f"flags {ms_tile_flags:.6g} ms; quiet state with the flags {ms_quiet_tile:.6g} "
        f"ms (tiles {quiet_tiles})")
    del states, blobs, out_st, out_mat, out_bl, load, step_fn, req, no_want, no_req
    del tile_step, member, n_comm
    torch.cuda.empty_cache()
    return {
        "arms": arms, "ms_per_replica_step": ms_step,
        "ms_per_replica_step_events": ms_events, "ms_quiet": ms_quiet,
        "share": bound / ms_step, "plan": plan,
        "ms_per_replica_step_tile": ms_tile, "tile_share": bound / ms_tile,
        "ms_tile_walk": ms_tile_walk, "ms_tile_walk_flags": ms_tile_flags,
        "ms_quiet_tile_flags": ms_quiet_tile, "quiet_tile_counts": quiet_tiles,
        "mean_n_committed_member": fold_chain,
        "ms_per_replica_step_fresh": ms_fresh, "bound_ms": bound,
        "plain_ms": plain_ms, "make_blob_ms": ms_blob,
        "make_blob_bound_ms": blob_bytes(G, W) / bw * 1e3,
        "peak_bytes": peak, "shape": HEADLINE,
        "capacity": bench_capacity(diff, device, bw),
        "ablation": bench_ablation(diff, device, results),
    }


def bench_capacity(diff: Diff, device, bw: float) -> dict:
    """The bench's capacity arm (``BENCH_G=2097152``): the headline loop at
    G=2,097,152, its first steps held against the plain version in
    G-tiles of ``CAPACITY_TILE`` groups (the engine is per group, so a
    tile's plain step is the full step's slice), then ``no_oom``, dec/s
    and the card's peak memory over the timed chunks beside the footprint
    estimate; gp_step's time per replica-step at this width (events)."""
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step
    from gigapaxos_tpu_torch.testing import bench

    G, W, K, R = (CAPACITY[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)

    def plain_in_tiles(load, t):
        snap = load.states
        for j in range(CAPACITY_PLAIN_STEPS):
            want = load.want(t + j)
            k_st, k_o = load.step_fn(snap, load.req, want)
            blobs = te.unpack_gathered(gp_kernels.make_blob_rows(snap, R), cfg)
            for g0 in range(0, G, CAPACITY_TILE):
                g1 = min(G, g0 + CAPACITY_TILE)
                tile = lambda tree: type(tree)(*(x[:, g0:g1] for x in tree))
                sub = te.EngineState(*(x[:, g0:g1].contiguous() for x in snap))
                fn = make_step(te.EngineConfig(g1 - g0, W, K, R), None, 1,
                               donate=False, io="stacked", device=device)
                p_st, p_o = fn.plain(sub, load.req[:, g0:g1], want[:, g0:g1])
                diff.tree("gp_step", f"capacity.{j}.g{g0}.state", tile(k_st), p_st)
                diff.tree("gp_step", f"capacity.{j}.g{g0}.out", tile(k_o), p_o)
                for r in range(R):
                    diff.tree("gp_make_blob", f"capacity.{j}.g{g0}.r{r}.blob",
                              te.Blob(*(x[r, g0:g1] for x in blobs)),
                              te.make_blob_plain(te.EngineState(*(x[r] for x in sub))))
                del sub, p_st, p_o
            snap = k_st
            del k_o, blobs
        del snap
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # the peak over the timed chunks (the parity's temporaries freed),
        # and the main path's counts from 0
        torch.cuda.reset_peak_memory_stats()
        te.reset_launch_counts()
        log(f"capacity: kernel bit-equal to the plain version at G={G} in "
            f"{-(-G // CAPACITY_TILE)} tiles of {CAPACITY_TILE} groups, "
            f"{CAPACITY_PLAIN_STEPS} step(s)")

    torch.cuda.empty_cache()
    cap, res = bench.capacity(G, W, K, device, after_warmup=plain_in_tiles)
    launches = dict(te.LAUNCHES)
    out = {"record": cap, "launches": launches, "shape": CAPACITY}
    if res is None:
        log(f"capacity: out of memory at G={G}: {cap}")
        return out
    if launches["gp_step"] < res["steps"] or res["total"] <= 0:
        fail(f"capacity: main path launched {launches}, committed {res['total']}")
    out["rsm_equal_frontier_cells"] = assert_rsm(res["states"])
    states = res["states"]
    del res
    blobs = gp_kernels.make_blob_rows(states, R)
    hm = torch.ones((R, R), dtype=torch.bool, device=device)
    req = torch.arange(1, K + 1, dtype=torch.int32, device=device)[None, None, :]
    req = req.expand(R, G, K).contiguous()
    no_want = torch.zeros((R, G), dtype=torch.bool, device=device)
    out_st = te.EngineState(*(torch.empty_like(x) for x in states))
    out_mat = torch.empty((R, te.out_vec_len(cfg)), dtype=torch.int32, device=device)
    out_bl = torch.empty_like(blobs)
    out["ms_per_replica_step_events"] = cuda_ms(lambda: gp_kernels.step_stacked(
        states, blobs, hm, req, no_want, cfg, out_states=out_st, out_mat=out_mat,
        out_blobs=out_bl), 10) / R
    out["bound_ms"] = stacked_step_bytes(G, W, K, R) / bw * 1e3
    del states, blobs, out_st, out_mat, out_bl, req
    torch.cuda.empty_cache()
    log(f"capacity: G={G}, no_oom {cap['no_oom']}, {cap['dec_per_s']:.6g} committed "
        f"decisions/s, peak device memory {cap['per_device_hbm_bytes']} B over the "
        f"timed chunks against the footprint module's estimate "
        f"{cap['footprint_estimate_bytes']} B (its state sets "
        f"{cap['footprint_state_bytes']} B); gp_step "
        f"{out['ms_per_replica_step_events']:.6g} ms per replica-step by events, "
        f"bound {out['bound_ms']:.6g} ms; launches {launches}; RSM ok on "
        f"{out['rsm_equal_frontier_cells']} equal-frontier cells")
    return out


def bench_ablation(diff: Diff, device, results: str) -> dict:
    """The bench's dispatch ablation (``BENCH_DISPATCH_ABLATION=1``) at its
    card shape: first the N=8 and N=1 faces held against the plain version
    from warmed states, then the ablation itself (per-step parity across N
    bit-exact, 480 against 60 host dispatches, both throughputs)."""
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.parallel.spmd import make_step
    from gigapaxos_tpu_torch.testing import bench

    G, W, K, R = (ABLATION[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)
    load = bench.StackedLoad(cfg, device)
    load.chunk(0, bench.WARM_CHUNKS * bench.CHUNK)
    states = load.states
    fn8 = make_step(cfg, None, 8, donate=False, io="stacked", device=device)
    ring = load.req[None].expand(8, R, G, K).contiguous()
    k8, p8 = fn8(states, ring, load.no_want), fn8.plain(states, ring, load.no_want)
    # N=8 is one gp_step_cluster launch a dispatch (phase 3b)
    diff.tree("gp_step_cluster", "ablation.n8.state", k8[0], p8[0])
    diff.tree("gp_step_cluster", "ablation.n8.out", k8[1], p8[1])
    del k8, p8, ring
    snap = states
    for j in range(ABLATION_PLAIN_STEPS):
        k_st, k_o = load.step_fn(snap, load.req, load.no_want)
        p_st, p_o = load.step_fn.plain(snap, load.req, load.no_want)
        diff.tree("gp_step", f"ablation.n1.{j}.state", k_st, p_st)
        diff.tree("gp_step", f"ablation.n1.{j}.out", k_o, p_o)
        snap = p_st
        del k_st, k_o, p_o
    del snap, states, load
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    te.reset_launch_counts()
    res = bench.dispatch_ablation(device)
    launches = dict(te.LAUNCHES)
    if res["shape"] != ABLATION:
        fail(f"ablation: ran at {res['shape']}, not {ABLATION}")
    a1, a8 = res["arms"]["n1"], res["arms"]["n8"]
    if not bench.ablation_ok(res) or (a1["host_dispatches"], a8["host_dispatches"]) != (480, 60):
        fail(f"ablation: {json.dumps(res)}")
    log(f"ablation: G={G}: per-step parity across N bit-exact over "
        f"{res['parity']['substeps']} substeps (decided {res['parity']['decided_n1']} "
        f"both), host dispatches {a1['host_dispatches']} against "
        f"{a8['host_dispatches']}; N=1 {a1['decided_per_s']:.6g} decided/s, N=8 "
        f"{a8['decided_per_s']:.6g} ({res['throughput_ratio_n8_vs_n1']}x); "
        f"launches {launches}")
    bench.write_out(os.path.join(results, "ablation.json"), res)
    return {"result": res, "launches": launches, "shape": ABLATION}


# ---------------------------------------------------------------------------
# phase 3b: the residency dispatch (N substeps a launch)
# ---------------------------------------------------------------------------


def packed_n_launches(state, gvec, heard, ring, want, my_id, cfg, heat, heat_out,
                      out_rings, g_work):
    """The packed dispatch as N ``gp_step`` launches, the design before one
    launch held the N substeps (timed beside it): MY row of a copy of the
    gathered matrix refreshed from each launch's blob, want at the first."""
    import torch

    from gigapaxos_tpu_torch.ops import gp_kernels

    N = ring.shape[0]
    no_want = torch.zeros_like(want)
    g, st = gvec, state
    for i in range(N):
        st, _, blob, _ = gp_kernels.step(
            st, g, heard, ring[i], want if i == 0 else no_want, my_id, cfg,
            with_blob=True, heat=heat if i == 0 else heat_out, heat_out=heat_out,
            out_vec=out_rings[i])
        if i < N - 1:
            if g is gvec:
                g_work.copy_(gvec)
                g = g_work
            g[my_id].copy_(blob)
    return st


def tile_states(states, G: int):
    """Replica states repeated along the group axis and cut to G groups."""
    from gigapaxos_tpu_torch.ops import engine as te

    G0 = states[0].bal.shape[0]
    n = -(-G // G0)
    return [te.EngineState(*(x.repeat((n,) + (1,) * (x.dim() - 1))[:G].contiguous()
                             for x in s)) for s in states]


def residency_case(diff: Diff, device, cfg, states, rng, serial: bool,
                   launches: dict, ns=RES_PARITY_N) -> None:
    """One parity shape and G of phase 3b: for each N in ``ns`` the
    packed face (MY id 0 and R-1, heat on, want set, a heard vector with
    misses) and the stacked face (every replica missing the last one) bit
    for bit against their plain faces and, with ``serial``, against N
    serial one-substep dispatches; one launch a dispatch."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.parallel.spmd import make_step, stack_states

    G, W, K, R = cfg
    dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    shp = f"G{G}W{W}R{R}K{K}"
    gvec = torch.stack([te.pack_blob(te.make_blob_plain(s)) for s in states])
    one = make_step(cfg, None, 1, donate=False, io="packed_host", heat=True, device=device)
    one_s = make_step(cfg, None, 1, donate=False, io="stacked", device=device)
    for N in ns:
        fn = make_step(cfg, None, N, donate=False, io="packed_host", heat=True, device=device)
        ring = rng.integers(1, 10 ** 6, size=(N, G, K))
        ring = np.where(rng.random((N, G, K)) < 0.3, -1, ring)
        ring = np.where(rng.random((N, G, K)) < 0.02, ring | (1 << 30), ring)
        ring = dev(ring.astype(np.int32), torch.int32)
        want = dev(rng.random(G) < 0.1, torch.bool)
        no_want = torch.zeros_like(want)
        heat = dev(rng.integers(0, 100, G).astype(np.int32), torch.int32)
        for my_id in sorted({0, R - 1}):
            heard = dev(rng.random(R) < 0.8, torch.bool)
            tag = f"residency.packed.{shp}.N{N}.r{my_id}"
            p = fn.plain(states[my_id], gvec, heard, ring, want, my_id, heat)
            te.reset_launch_counts()
            k = fn(states[my_id], gvec, heard, ring, want, my_id, heat)
            got = dict(te.LAUNCHES)
            launches["packed"].append(got["gp_step_n"])
            diff.same("gp_step_n", tag + ".launches",
                      got["gp_step_n"] == 1 and sum(got.values()) == 1)
            diff.tree("gp_step_n", tag + ".state", k[0], p[0])
            for j, what in ((1, "rings"), (2, "blob"), (3, "heat")):
                diff.eq("gp_step_n", f"{tag}.{what}", k[j], p[j])
            if not serial:
                continue
            # N serial one-substep dispatches, MY row refreshed from each
            # one's blob
            st, g, h, rows = states[my_id], gvec, heat, []
            for s in range(N):
                st, o, blob, h = one(st, g, heard, ring[s:s + 1],
                                     want if s == 0 else no_want, my_id, h)
                rows.append(o[0])
                g = gvec.clone()
                g[my_id] = blob
            diff.tree("gp_step_n", tag + ".serial.state", k[0], st)
            diff.eq("gp_step_n", tag + ".serial.rings", k[1], torch.stack(rows))
            diff.eq("gp_step_n", tag + ".serial.blob", k[2], blob)
            diff.eq("gp_step_n", tag + ".serial.heat", k[3], h)
        fs = make_step(cfg, None, N, donate=False, io="stacked", device=device)
        stacked = stack_states(states)
        reqs = rng.integers(1, 10 ** 6, size=(N, R, G, K))
        reqs = dev(np.where(rng.random((N, R, G, K)) < 0.3, -1, reqs)
                   .astype(np.int32), torch.int32)
        wants = dev(rng.random((R, G)) < 0.05, torch.bool)
        hm = np.ones((R, R), bool)
        if R > 1:
            hm[:, R - 1] = False   # every replica misses the last one
        hm = dev(hm, torch.bool)
        tag = f"residency.stacked.{shp}.N{N}"
        te.reset_launch_counts()
        k_st, k_o = fs(stacked, reqs, wants, hm)
        got = dict(te.LAUNCHES)
        launches["stacked"].append(got["gp_step_cluster"])
        diff.same("gp_step_cluster", tag + ".launches",
                  fs.route == "cluster" and got["gp_step_cluster"] == 1
                  and sum(got.values()) == 1)
        p_st, p_o = fs.plain(stacked, reqs, wants, hm)
        diff.tree("gp_step_cluster", tag + ".state", k_st, p_st)
        diff.tree("gp_step_cluster", tag + ".out", k_o, p_o)
        if not serial:
            continue
        st, outs = stacked, []
        for s in range(N):
            st, o = one_s(st, reqs[s], wants if s == 0 else torch.zeros_like(wants), hm)
            outs.append(o)
        diff.tree("gp_step_cluster", tag + ".serial.state", k_st, st)
        diff.tree("gp_step_cluster", tag + ".serial.out", k_o,
                  te.StepOutputs(*(torch.stack(x) for x in zip(*outs))))


def stacked_n1_case(diff: Diff, device, cfg, states, rng, launches: dict) -> None:
    """The stacked face at N = 1 (one gp_step launch, a CTA a tile of R
    replicas), every replica missing the last, with want pulses, bit for
    bit against the plain face and against the route it replaced,
    gp_make_blob and a stacked gp_step through the [R, NB] matrix."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step, stack_states

    G, W, K, R = cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas
    dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    fs = make_step(cfg, None, 1, donate=False, io="stacked", device=device)
    stacked = stack_states(states)
    reqs = rng.integers(1, 10 ** 6, size=(R, G, K))
    reqs = dev(np.where(rng.random((R, G, K)) < 0.3, -1, reqs).astype(np.int32), torch.int32)
    wants = dev(rng.random((R, G)) < 0.05, torch.bool)
    hm = np.ones((R, R), bool)
    if R > 1:
        hm[:, R - 1] = False   # every replica misses the last one
    hm = dev(hm | np.eye(R, dtype=bool), torch.bool)
    tag = f"residency.stacked.G{G}W{W}R{R}K{K}.N1"
    te.reset_launch_counts()
    k_st, k_o = fs(stacked, reqs, wants, hm)
    got = dict(te.LAUNCHES)
    launches["stacked_n1"].append(got["gp_step"])
    diff.same("gp_step", tag + ".launches",
              fs.route == "tile" and got["gp_step"] == 1 and sum(got.values()) == 1)
    p_st, p_o = fs.plain(stacked, reqs, wants, hm)
    diff.tree("gp_step", tag + ".state", k_st, p_st)
    diff.tree("gp_step", tag + ".out", k_o, p_o)
    o_st, o_mat, _ = gp_kernels.step_stacked(
        stacked, gp_kernels.make_blob_rows(stacked, R), hm, reqs, wants, cfg)
    diff.tree("gp_step", tag + ".launches_route.state", k_st, o_st)
    diff.tree("gp_step", tag + ".launches_route.out", k_o, fs._outs(o_mat))
    # the skip: the face's own states walked with no input, each call
    # against the plain face.  The seeded states come to rest within 7
    # calls (the plain face on the CPU), and after the busy call above the
    # face takes the skip build again at its next probe, within PROBE
    # calls; the calls after it copy the resting tiles through
    no_req = torch.full_like(reqs, -1)
    no_want = torch.zeros_like(wants)
    st = k_st
    torch.cuda.synchronize()
    gp_kernels.reset_tile_counts()
    for i in range(gp_kernels.PROBE + 8):
        q_st, q_o = fs(st, no_req, no_want, hm)
        p_st, p_o = fs.plain(st, no_req, no_want, hm)
        diff.tree("gp_step", f"{tag}.quiet{i}.state", q_st, p_st)
        diff.tree("gp_step", f"{tag}.quiet{i}.out", q_o, p_o)
        st = q_st
    tiles = gp_kernels.tile_counts()
    diff.same("gp_step", tag + ".quiet.skipped", tiles["skipped"] > 0)


def residency_parity(diff: Diff, device) -> dict:
    """Both N-substep kernels bit for bit against their plain faces at
    every parity shape and G, N in RES_PARITY_N, and against N serial
    one-substep dispatches at the first parity G (:func:`residency_case`);
    the stacked face at N = 1 against its plain face and the two-launch
    route it replaced at the same shapes (:func:`stacked_n1_case`); then
    RES_PARITY_BIG at the deployed N (8), where every CTA of both launches
    takes three tiles or more, so the ring refills stages the substeps
    wrote."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels

    t0 = time.perf_counter()
    launches = {"packed": [], "stacked": [], "stacked_n1": []}
    for G in PARITY_GS:
        for i, (W, R, K) in enumerate(PARITY_SHAPES):
            cfg = te.EngineConfig(G, W, K, R)
            states = seeded_states(cfg, 100 + i + G, device)
            residency_case(diff, device, cfg, states, np.random.default_rng(500 + i + G),
                           G == PARITY_GS[0], launches)
            stacked_n1_case(diff, device, cfg, states, np.random.default_rng(700 + i + G),
                            launches)
    G, (W, R, K) = RES_PARITY_BIG
    i = PARITY_SHAPES.index((W, R, K))
    cfg = te.EngineConfig(G, W, K, R)
    N = RES_SERVER_N
    pk = gp_kernels.step_launch_plan(cfg, n_sub=N)
    cl = gp_kernels.step_launch_plan(cfg, n_sub=N, cluster=True)
    tiles = (pk["n_items"] // pk["grid"], cl["n_items"] // (cl["grid"] // R))
    if min(tiles) < 3:
        fail(f"residency parity at G={G}: {tiles} tiles a CTA, not 3 or more "
             f"(packed {plan_str(pk)}; cluster {plan_str(cl)})")
    base = seeded_states(te.EngineConfig(PARITY_GS[0], W, K, R), 100 + i + PARITY_GS[0],
                         device)
    residency_case(diff, device, cfg, tile_states(base, G), np.random.default_rng(500 + G),
                   False, launches, (N,))
    torch.cuda.synchronize()
    _SEEDED.clear()
    secs = time.perf_counter() - t0
    log(f"residency parity: gp_step_n {diff.checked['gp_step_n']} and gp_step_cluster "
        f"{diff.checked['gp_step_cluster']} comparisons bit-equal at "
        f"{len(PARITY_SHAPES)} shapes x G in {PARITY_GS}, N in {RES_PARITY_N}, against "
        f"the plain faces, and against N serial dispatches at G={PARITY_GS[0]}; at "
        f"G={G}, (W, R, K)={(W, R, K)}, N={N} too, the least tiles a CTA (packed, "
        f"cluster) {tiles}; launches a dispatch: packed "
        f"{sorted(set(launches['packed']))} gp_step_n, stacked "
        f"{sorted(set(launches['stacked']))} gp_step_cluster and no gp_make_blob; "
        f"stacked N=1 {sorted(set(launches['stacked_n1']))} gp_step (a CTA a tile), "
        f"bit-equal to the plain face and to gp_make_blob + gp_step "
        f"({secs:.1f} s)")
    return {"seconds": secs, "tiles_per_cta_big": tiles, "launches_per_dispatch": {
        k: sorted(set(v)) for k, v in launches.items()}}


def warm_states(cfg, device, steps: int = 10):
    """Stacked replica states after ``steps`` loaded steps (K requests a
    group a step), as phase 3's step-shape timings load them."""
    import torch

    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    G, K, R = cfg.n_groups, cfg.req_lanes, cfg.n_replicas
    fn = make_step(cfg, None, 1, donate=True, io="stacked", device=device)
    req = torch.arange(1, K + 1, dtype=torch.int32, device=device)
    req = req[None, None, :].expand(R, G, K).contiguous()
    want = torch.zeros((R, G), dtype=torch.bool, device=device)
    states = build_replica_states(cfg, device=device)
    for _ in range(steps):
        states, _ = fn(states, req, want)
    return states, req


def timed_once(fn):
    """One call of ``fn`` between CUDA events: (its result, ms).  For the
    plain faces, whose one call takes tens to hundreds of ms."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def residency_packed_times(diff: Diff, device, bw: float, label: str, shape: dict) -> dict:
    """The packed dispatch of replica 0 at N in RES_PACKED_N: the face (one
    launch, ``gp_step`` at N = 1, ``gp_step_n`` above; N = 1 also through
    ``gp_step_n``) bit for bit against its plain face, then timed on the
    device (a CUDA graph of dispatches) beside the N-launch design it
    replaces, the plain face (its one call), the work's bound (the state
    once) and the N-launch design's own bound (N replica-steps)."""
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step

    G, W, K, R = (shape[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)
    # a dispatch of milliseconds needs fewer in its graph
    gms = (lambda fn: graph_ms(fn, calls=5, reps=4)) if G * W > 2 ** 22 else graph_ms
    states, req = warm_states(cfg, device)
    st = te.EngineState(*(x[0].contiguous() for x in states))
    gvec = gp_kernels.make_blob_rows(states, R)
    del states
    heard = torch.ones(R, dtype=torch.bool, device=device)
    want = torch.zeros(G, dtype=torch.bool, device=device)
    heat = torch.zeros(G, dtype=torch.int32, device=device)
    out_st = te.EngineState(*(torch.empty_like(x) for x in st))
    M, NB = te.out_vec_len(cfg), te.blob_vec_len(cfg)
    blob = torch.empty(NB, dtype=torch.int32, device=device)
    g_work = torch.empty_like(gvec)
    res = {}
    for N in RES_PACKED_N:
        ring = req[0][None].expand(N, G, K).contiguous()
        fn = make_step(cfg, None, N, donate=False, io="packed_host", heat=True,
                       device=device)
        p, plain_ms = timed_once(lambda: fn.plain(st, gvec, heard, ring, want, 0, heat))
        tag = f"residency.{label}.N{N}"
        checks = [("gp_step_n" if N > 1 else "gp_step",
                   fn(st, gvec, heard, ring, want, 0, heat))]
        if N == 1:
            checks.append(("gp_step_n", gp_kernels.step_n(
                st, gvec, heard, ring, want, 0, cfg, heat=heat)))
        for name, k in checks:
            diff.tree(name, f"{tag}.{name}.state", k[0], p[0])
            for j, what in ((1, "rings"), (2, "blob"), (3, "heat")):
                diff.eq(name, f"{tag}.{name}.{what}", k[j], p[j])
        del p, checks, k
        # the timed launches accumulate into the heat in place
        rings = torch.empty((N, M), dtype=torch.int32, device=device)
        one = lambda: gp_kernels.step_n(
            st, gvec, heard, ring, want, 0, cfg, out_state=out_st, heat=heat,
            heat_out=heat, out_rings=rings, out_blob=blob)
        ms = gms(one)
        r = {"ms": ms, "ms_events": cuda_ms(one, 10), "plain_ms": plain_ms,
             "bound_ms": packed_bytes(G, W, K, R, N) / bw * 1e3,
             "n_launch_bound_ms": N * step_bytes(G, W, K, R) / bw * 1e3}
        if N == 1:
            r["ms_gp_step"] = gms(lambda: gp_kernels.step(
                st, gvec, heard, ring[0], want, 0, cfg, with_blob=True,
                out_state=out_st, heat=heat, heat_out=heat, out_vec=rings[0],
                out_blob=blob))
        else:
            r["ms_n_launches"] = gms(lambda: packed_n_launches(
                st, gvec, heard, ring, want, 0, cfg, heat, heat, rings, g_work))
        r["plan"] = gp_kernels.step_launch_plan(cfg, n_sub=N)
        r["share"] = r["bound_ms"] / ms
        res[N] = r
        log(f"residency {label} (G={G}, W={W}, K={K}, R={R}) packed N={N}: bit-equal "
            f"to the plain face; one launch "
            f"{ms:.6g} ms on the device ({r['ms_events']:.6g} by events), "
            f"{100 * r['share']:.4g}% of the {r['bound_ms']:.6g} ms bound (the state "
            f"once; N launches' own bound {r['n_launch_bound_ms']:.6g} ms); "
            + (f"gp_step {r['ms_gp_step']:.6g} ms" if N == 1 else
               f"N gp_step launches {r['ms_n_launches']:.6g} ms")
            + f"; plain {r['plain_ms']:.6g} ms; plan {plan_str(r['plan'])}")
        del ring, rings
    del st, gvec, out_st, g_work
    torch.cuda.empty_cache()
    return {"shape": shape, "by_n": res}


def stacked_n_launches(states, ring, want, h, cfg, mat, blobs, blobs_next):
    """The stacked dispatch as a gp_make_blob and N stacked gp_step launches
    through a double-buffered blob matrix: the stacked face's route for R
    above the cluster size, timed beside the one-launch routes."""
    import torch

    from gigapaxos_tpu_torch.ops import gp_kernels

    N = ring.shape[0]
    no_want = torch.zeros_like(want)
    gp_kernels.make_blob_rows(states, cfg.n_replicas, out=blobs)
    st = states
    for i in range(N):
        st, _, _ = gp_kernels.step_stacked(
            st, blobs, h, ring[i], want if i == 0 else no_want, cfg, out_mat=mat[i],
            out_blobs=blobs_next if i < N - 1 else None)
        blobs, blobs_next = blobs_next, blobs
    return st


def residency_stacked_times(diff: Diff, device, bw: float, label: str, shape: dict,
                            ns) -> dict:
    """The stacked dispatch at ``shape`` for N in ``ns``, one launch (a
    gp_step with a CTA a tile at N = 1, one
    gp_step_cluster at N > 1), bit for bit against the plain face and the
    gp_make_blob + N gp_step route it replaced, then timed on the device
    (a CUDA graph of dispatches) beside that route, the plain face (its
    one call) and the work's bound."""
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import make_step

    G, W, K, R = (shape[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)
    states, req = warm_states(cfg, device)
    want = torch.zeros((R, G), dtype=torch.bool, device=device)
    h = torch.ones((R, R), dtype=torch.bool, device=device)
    res = {}
    for N in ns:
        ring = req[None].expand(N, R, G, K).contiguous()
        face = make_step(cfg, None, N, donate=False, io="stacked", device=device)
        arg = ring if N > 1 else ring[0]
        p, plain_ms = timed_once(lambda: face.plain(states, arg, want, h))
        name = "gp_step_cluster" if N > 1 else "gp_step"
        te.reset_launch_counts()
        k = face(states, arg, want, h)
        diff.same(name, f"residency.{label}.N{N}.launches",
                  face.route == ("cluster" if N > 1 else "tile")
                  and te.LAUNCHES[name] == 1 and sum(te.LAUNCHES.values()) == 1)
        diff.tree(name, f"residency.{label}.N{N}.state", k[0], p[0])
        diff.tree(name, f"residency.{label}.N{N}.out", k[1], p[1])
        out_st = te.EngineState(*(torch.empty_like(x) for x in states))
        mat = torch.empty((N, R, te.out_vec_len(cfg)), dtype=torch.int32, device=device)
        blobs = torch.empty((2, R, te.blob_vec_len(cfg)), dtype=torch.int32, device=device)
        st = stacked_n_launches(states, ring, want, h, cfg, mat, blobs[0], blobs[1])
        diff.tree(name, f"residency.{label}.N{N}.launches_route.state", k[0], st)
        diff.tree(name, f"residency.{label}.N{N}.launches_route.out", k[1],
                  face._outs(mat if N > 1 else mat[0]))
        del k, p, st
        r = {"route": face.route, "plain_ms": plain_ms,
             "bound_ms": cluster_bytes(G, W, K, R, N) / bw * 1e3}
        if N > 1:
            one = lambda: gp_kernels.step_cluster(
                states, h, ring, want, cfg, out_states=out_st, out_mat=mat)
            r["plan"] = gp_kernels.step_launch_plan(cfg, n_sub=N, cluster=True)
        else:
            one = lambda: gp_kernels.step_stacked(
                states, None, h, ring[0], want, cfg, out_states=out_st, out_mat=mat[0])
            r["plan"] = gp_kernels.step_launch_plan(cfg, tile=True)
        r["ms"] = graph_ms(one, calls=5, reps=4)
        r["ms_n_launches"] = graph_ms(lambda: stacked_n_launches(
            states, ring, want, h, cfg, mat, blobs[0], blobs[1]), calls=5, reps=4)
        r["n_launch_bound_ms"] = (N * R * stacked_step_bytes(G, W, K, R)
                                  + R * blob_bytes(G, W)) / bw * 1e3
        del out_st, mat, blobs
        r["share"] = r["bound_ms"] / r["ms"]
        res[N] = r
        log(f"residency {label} (G={G}, W={W}, K={K}, R={R}) stacked N={N} "
            f"({face.route}): bit-equal to the plain face and to gp_make_blob + N "
            f"gp_step; {r['ms']:.6g} ms a dispatch on the device, "
            f"{100 * r['share']:.4g}% of the {r['bound_ms']:.6g} ms bound; gp_make_blob + "
            f"N launches {r['ms_n_launches']:.6g} ms (their own bound "
            f"{r['n_launch_bound_ms']:.6g} ms); plain {r['plain_ms']:.6g} ms; plan "
            f"{plan_str(r['plan'])}")
        del ring
    del states
    torch.cuda.empty_cache()
    return {"shape": shape, "by_n": res}


def residency_server(device) -> dict:
    """Phase 6's servers through their entry points with the deployed
    residency knob ENGINE_STEPS_PER_DISPATCH=8: every response correct,
    and each manager's dispatches one gp_step_n launch each (no gp_step)."""
    from gigapaxos_tpu_torch.utils.config import Config

    Config.set("ENGINE_STEPS_PER_DISPATCH", str(RES_SERVER_N))
    try:
        res = phase_server(device, RES_SERVER_NAMES, RES_SERVER_REQS_PER_NAME,
                           RES_SERVER_HIBERNATE, RES_SERVER_POST_REQS_PER_NAME,
                           label=f"residency server N={RES_SERVER_N}")
    finally:
        # the default (paxos_config.py) for every later phase
        Config.set("ENGINE_STEPS_PER_DISPATCH", "1")
    if res["steps_per_dispatch"] != RES_SERVER_N:
        fail(f"residency server: the managers ran N={res['steps_per_dispatch']}")
    before, after = res["ticks_around_launches"]
    for i, m in enumerate(res["per_manager_launches"]):
        n = m.get("gp_step_n", 0)
        if m.get("gp_step", 0) != 0 or not before[i] <= n <= after[i] + 1:
            fail(f"residency server: manager {i} launched {m} over {before[i]}-"
                 f"{after[i]} ticks: not one gp_step_n a dispatch")
    log(f"residency server N={RES_SERVER_N}: each manager one gp_step_n a dispatch "
        f"(ticks {after}), no gp_step: {res['per_manager_launches']}")
    return res


def phase_residency(diff: Diff, device, bw: float) -> dict:
    """Phase 3b: the N-substep dispatch on the card (module docstring)."""
    t0 = time.perf_counter()
    out = {"parity": residency_parity(diff, device)}
    out["server_shape"] = residency_packed_times(diff, device, bw, "server", SERVER)
    out["headline_shape"] = residency_packed_times(diff, device, bw, "headline", HEADLINE)
    for label, shape, ns in RES_STACKED:
        out[f"{label}_stacked"] = residency_stacked_times(diff, device, bw, label, shape, ns)
    out["server"] = residency_server(device)
    out["launches"] = out["server"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    log(f"residency: phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 4: the server path
# ---------------------------------------------------------------------------


def server_diag(servers) -> str:
    """Tick and transport counters of the servers (failure context)."""
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

    per = [
        {"ticks": s._tick, "sent": s.transport.n_sent,
         "rcvd": s.transport.n_rcvd, "dropped": s.transport.n_dropped,
         "coalesced": s.transport.n_coalesced,
         "engine_step_s": s.manager.last_engine_step_s}
        for s in servers
    ]
    return f"servers {per}; profiler {DelayProfiler.get_stats()}"


def tick_stages_ms(before: dict, after: dict) -> dict:
    """Milliseconds per tick of each host stage a ``DelayProfiler`` sums
    (its ``t_*`` counts), over the window between two snapshots of its
    counts (``n_ticks`` counts the ticks of every server it serves)."""
    n = after.get("n_ticks", 0) - before.get("n_ticks", 0)
    if n <= 0:
        return {}
    return {k: 1e3 * (after[k] - before.get(k, 0)) / n
            for k in sorted(after) if k.startswith("t_")}


def phase_server(device, n_names: int = SERVER_NAMES,
                 reqs_per_name: int = SERVER_REQS_PER_NAME,
                 n_hibernate: int = SERVER_HIBERNATE,
                 post_reqs_per_name: int = SERVER_POST_REQS_PER_NAME,
                 label: str = "server") -> dict:
    """3 PaxosServers in this process on the card at the server shape:
    ``n_names`` names, ``reqs_per_name`` requests each (every response the
    expected running total), ``n_hibernate`` names hibernated and restored
    on every server by the admin plane, then ``post_reqs_per_name`` more
    requests each.  The servers take the engine settings in effect (phase
    3b runs it at ENGINE_STEPS_PER_DISPATCH=8)."""
    import numpy as np

    from gigapaxos_tpu_torch.clients import PaxosClientAsync
    from gigapaxos_tpu_torch.models import StatefulAdderApp
    from gigapaxos_tpu_torch.net.node_config import NodeConfig
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.server import PaxosServer
    from gigapaxos_tpu_torch.testing.ports import free_ports
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

    G, W, K, R = (SERVER[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)
    te.reset_launch_counts()
    ports = free_ports(R)
    nc = NodeConfig({i: ("127.0.0.1", p) for i, p in enumerate(ports)})
    servers = [
        PaxosServer(i, nc, StatefulAdderApp(), cfg, tick_interval=0.01,
                    fd_timeout_s=30.0, device=device)
        for i in range(R)
    ]
    client = None
    try:
        for s in servers:
            s.start()
        t_started = time.perf_counter()
        client = PaxosClientAsync([("127.0.0.1", p) for p in ports])
        names = [f"svc{i}" for i in range(n_names)]
        t_create = time.perf_counter()
        for nm in names:
            if not client.create_paxos_instance(nm, list(range(R)), timeout=60):
                fail(f"{label}: create {nm} failed")
        t_create = time.perf_counter() - t_create
        lat, errors = [], []
        lock = threading.Lock()
        expected: dict = {nm: 0 for nm in names}

        def chain(nm: str, seed: int, n_reqs: int) -> None:
            rng = np.random.default_rng(seed)
            total = expected[nm]
            for _ in range(n_reqs):
                v = int(rng.integers(1, 100))
                t0 = time.perf_counter()
                resp = client.send_request_sync(nm, str(v), timeout=60)
                dt = time.perf_counter() - t0
                total += v
                with lock:
                    lat.append(dt)
                    if resp != str(total):
                        errors.append((nm, resp, total))
            with lock:
                expected[nm] = total

        def run_chains(n_reqs: int, seed0: int) -> float:
            threads = [threading.Thread(target=chain, args=(nm, seed0 + i, n_reqs))
                       for i, nm in enumerate(names)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            if errors:
                fail(f"{label}: {len(errors)} wrong responses, first {errors[0]}; "
                     f"{server_diag(servers)}")
            return wall

        def converge(what: str) -> None:
            deadline = time.time() + 60
            while time.time() < deadline:
                if all(s.manager.app.totals.get(nm) == expected[nm]
                       for s in servers for nm in names):
                    return
                time.sleep(0.1)
            bad = {nm: [s.manager.app.totals.get(nm) for s in servers]
                   for nm in names
                   if any(s.manager.app.totals.get(nm) != expected[nm]
                          for s in servers)}
            fail(f"{label}: {what}: replicas' app totals disagree with the "
                 f"responses: {dict(list(bad.items())[:4])} expected "
                 f"{ {nm: expected[nm] for nm in list(bad)[:4]} }; "
                 f"{server_diag(servers)}")

        # ticks/s and the host stages of a tick over the request window
        # alone, as phase 10 counts them
        ticks0 = [s._tick for s in servers]
        prof0 = DelayProfiler.get_snapshot()["counts"]
        wall = run_chains(reqs_per_name, 0)
        ticks_per_s = [(s._tick - t) / wall for s, t in zip(servers, ticks0)]
        stages = tick_stages_ms(prof0, DelayProfiler.get_snapshot()["counts"])
        converge("after the first requests")
        n = len(lat)
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        # the admin plane: hibernate some names on every server (a forced
        # pause and a kill, gp_kill_groups), then restore them (a create
        # and a record install, gp_create_groups + gp_restore_paused_rows)
        t_hib = time.perf_counter()
        for op in ("hibernate", "restore"):
            for i in range(R):
                for nm in names[:n_hibernate]:
                    r = client.admin_sync(i, {"op": op, "name": nm}, timeout=60)
                    if not r or not r.get("ok"):
                        fail(f"{label}: admin {op} {nm} on server {i}: {r}")
        for i, s in enumerate(servers):
            for nm in names[:n_hibernate]:
                if s.manager.app.totals.get(nm) != expected[nm]:
                    fail(f"{label}: {nm} restored on server {i} with total "
                         f"{s.manager.app.totals.get(nm)}, expected {expected[nm]}")
        t_hib = time.perf_counter() - t_hib
        lat.clear()
        wall_post = run_chains(post_reqs_per_name, 1000)
        converge("after hibernate and restore")
        n_post = len(lat)
        # every tick is one dispatch: the ticks read around the launch
        # counts bound each manager's dispatches (one may be in flight)
        ticks_before = [s._tick for s in servers]
        per_mgr = [dict(s.manager.kernel_launches) for s in servers]
        ticks_after = [s._tick for s in servers]
        # the dispatch's one launch: gp_step, or gp_step_n at N > 1
        kname = "gp_step" if servers[0].manager.steps_per_dispatch == 1 else "gp_step_n"
        if any(m.get(kname, 0) <= 0 for m in per_mgr):
            fail(f"{label}: a manager never launched {kname}: {per_mgr}")
        launches = dict(te.LAUNCHES)
        for k in ("gp_create_groups", "gp_kill_groups", "gp_restore_paused_rows"):
            if launches[k] <= 0:
                fail(f"{label}: {k} never launched: {launches}")
        ticks_phase = [s._tick / (time.perf_counter() - t_started) for s in servers]
        res = {
            "requests": n, "names": len(names), "seconds": wall,
            "req_per_s": n / wall, "ticks_per_s": ticks_per_s,
            "ticks_per_s_phase": ticks_phase, "tick_stages_ms": stages,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "create_seconds": t_create,
            "hibernated": n_hibernate, "hibernate_restore_seconds": t_hib,
            "post_restore_requests": n_post, "post_restore_seconds": wall_post,
            "launches": launches, "per_manager_launches": per_mgr,
            "ticks_around_launches": [ticks_before, ticks_after],
            "steps_per_dispatch": servers[0].manager.steps_per_dispatch,
            "shape": SERVER,
        }
        log(f"{label}: {server_diag(servers)}")
        log(f"{label}: {n} requests over {len(names)} names answered "
            f"correctly in {wall:.4f} s: {res['req_per_s']:.6g} req/s, "
            f"p50 {res['p50_ms']:.6g} ms, p99 {res['p99_ms']:.6g} ms; "
            f"{n_hibernate} names hibernated and restored on all "
            f"{R} servers in {t_hib:.4f} s, then {n_post} more requests "
            f"correct in {wall_post:.4f} s; ticks/s per server over the first "
            f"requests {[round(t, 4) for t in ticks_per_s]} (over the phase "
            f"{[round(t, 4) for t in ticks_phase]}); host stages of a tick "
            f"over the first requests, ms per tick: {stages}; "
            f"launches {launches}, per manager {per_mgr}")
        return res
    finally:
        if client is not None:
            client.close()
        for s in servers:
            s.stop()


def phase_step_shapes(diff: Diff, device, bw: float) -> dict:
    """The step launches of the server and density paths at their shapes
    (``STEP_SHAPES``), held against the plain version: the manager's
    dispatch step (packed face, N=1; heat updated in place, as the
    dispatch does, and into a fresh vector, as the tick does) for every
    replica id, and gp_make_blob of every replica's state, on
    kernel-loaded states and on fuzzed seeded states.  Then the times of
    gp_step, gp_make_blob and the plain versions at each shape."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel.spmd import build_replica_states, make_step

    res = {}
    for si, (shape, dims) in enumerate(STEP_SHAPES.items()):
        G, W, K, R = (dims[k] for k in ("G", "W", "K", "R"))
        cfg = te.EngineConfig(G, W, K, R)
        fn = make_step(cfg, None, 1, donate=False, io="stacked", device=device)
        req = torch.arange(1, K + 1, dtype=torch.int32, device=device)
        req = req[None, None, :].expand(R, G, K).contiguous()
        want = torch.zeros((R, G), dtype=torch.bool, device=device)
        states = build_replica_states(cfg, device=device)
        for _ in range(10):
            states, _ = fn(states, req, want)

        t0 = time.perf_counter()
        rng = np.random.default_rng(300 + 10 * si)
        dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        cases = {
            "loaded": [te.EngineState(*(x[r].contiguous() for x in states))
                       for r in range(R)],
            "fuzzed": make_seeded_states(cfg, 301 + 10 * si, device),
        }
        for donate in (True, False):
            dispatch = make_step(cfg, None, 1, donate=donate, io="packed_host",
                                 heat=True, device=device)
            for name, sts in cases.items():
                gvec = torch.stack([te.pack_blob(te.make_blob_plain(s)) for s in sts])
                if donate:
                    for r, s in enumerate(sts):
                        diff.eq("gp_make_blob", f"{shape}.{name}.r{r}.blob",
                                gp_kernels.make_blob_vec(s), gvec[r])
                for my_id in range(R):
                    heard = dev(rng.random(R) < 0.85, torch.bool)
                    ring = rng.integers(1, 10 ** 6, size=(1, G, K))
                    ring = np.where(rng.random((1, G, K)) < 0.3, -1, ring)
                    ring = dev(ring.astype(np.int32), torch.int32)
                    want1 = dev(rng.random(G) < 0.05, torch.bool)
                    heat = dev(rng.integers(0, 100, G).astype(np.int32), torch.int32)
                    # my_id as the manager passes it (np.int32): the step's
                    # retrace sentinel, shared with the managers of the
                    # later phases, then sees their signature here first
                    p = dispatch.plain(sts[my_id], gvec, heard, ring, want1,
                                       np.int32(my_id), heat)
                    k = dispatch(sts[my_id], gvec, heard, ring, want1,
                                 np.int32(my_id), heat.clone())
                    tag = f"{shape}.{name}.d{int(donate)}.r{my_id}"
                    diff.tree("gp_step", tag + ".state", k[0], p[0])
                    for j, what in ((1, "out"), (2, "blob"), (3, "heat")):
                        diff.eq("gp_step", f"{tag}.{what}", k[j], p[j])
        torch.cuda.synchronize()
        log(f"{shape} shape parity (G={G}, W={W}, K={K}, R={R}): bit-equal "
            f"({time.perf_counter() - t0:.1f} s)")

        st = te.EngineState(*(x[0].contiguous() for x in states))
        gvec = gp_kernels.make_blob_rows(states, R)
        heard = torch.ones(R, dtype=torch.bool, device=device)
        out_st = te.EngineState(*(torch.empty_like(x) for x in st))
        heat = torch.zeros(G, dtype=torch.int32, device=device)
        launch = lambda: gp_kernels.step(
            st, gvec, heard, req[0], want[0], 0, cfg, with_blob=True,
            out_state=out_st, heat=heat, heat_out=heat)
        plan = gp_kernels.step_launch_plan(cfg)
        # the launch on the device (a CUDA graph of launches), and by the
        # events around a loop of wrapper calls (which reads the wrapper's
        # host work at small shapes)
        ms = graph_ms(launch)
        ms_events = cuda_ms(launch, TIMING_ITERS)
        # the same loop with the wrapper allocating the new state (what
        # make_step does): the caching allocator's cost per step
        ms_fresh = cuda_ms(lambda: gp_kernels.step(
            st, gvec, heard, req[0], want[0], 0, cfg, with_blob=True,
            heat=heat, heat_out=heat), TIMING_ITERS)
        g = te.unpack_gathered(gvec, cfg)

        def plain():
            p_st, p_o = te.step_plain(st, g, heard, req[0], want[0], 0, cfg)
            te.pack_out(p_o)
            te.pack_blob(te.make_blob_plain(p_st))

        plain_ms = cuda_ms(plain, 3)
        blob_ms = graph_ms(lambda: gp_kernels.make_blob_vec(st))
        blob_ms_events = cuda_ms(lambda: gp_kernels.make_blob_vec(st), TIMING_ITERS)
        blob_plain_ms = cuda_ms(lambda: te.pack_blob(te.make_blob_plain(st)), 5)
        res[shape] = {
            "shape": dims, "ms": ms, "ms_events": ms_events, "ms_fresh": ms_fresh,
            "plain_ms": plain_ms, "make_blob_ms_events": blob_ms_events,
            "bound_ms": step_bytes(G, W, K, R) / bw * 1e3,
            "make_blob_ms": blob_ms, "make_blob_plain_ms": blob_plain_ms,
            "make_blob_bound_ms": blob_bytes(G, W) / bw * 1e3,
            "plan": plan,
        }
        r = res[shape]
        r["share"] = r["bound_ms"] / ms
        log(f"{shape} shape gp_step: {ms:.6g} ms on the device into a "
            f"preallocated state, {100 * r['share']:.4g}% of the bound "
            f"({ms_events:.6g} ms by events around a loop, "
            f"{ms_fresh:.6g} ms into a fresh one; bound {r['bound_ms']:.6g} ms, "
            f"plain {plain_ms:.6g} ms; plan {plan_str(plan)}); gp_make_blob "
            f"{blob_ms:.6g} ms on the "
            f"device ({blob_ms_events:.6g} ms by events; bound "
            f"{r['make_blob_bound_ms']:.6g} ms, plain {blob_plain_ms:.6g} ms)")
        del states, cases, st, gvec, out_st, g
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 10: sharded serving over sockets; phase 11: transactions; phase 12:
# the chaos soaks
# ---------------------------------------------------------------------------


def node_ports(n: int, offsets=(0,)) -> list:
    """``n`` loopback base ports for nodes that also listen at base +
    offset (the HTTP front, the serving workers): each base with all its
    derived ports free at once, none shared between two bases.  Taken
    below the OS's ephemeral range where it leaves room, so that no
    connection's local port can take one before its node binds it."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        lo = 0
    span = (10_000, lo - max(offsets) - 1)
    rng = random.Random()
    held, out = [], []
    try:
        for _ in range(10_000):
            if len(out) == n:
                return out
            if span[1] - span[0] >= 1000:
                base = rng.randrange(*span)
            else:   # no room below: the OS's picks, checked alike
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    base = s.getsockname()[1]
                if base + max(offsets) > 65535:
                    continue
            socks = []
            try:
                for off in offsets:
                    s = socket.socket()
                    socks.append(s)
                    s.bind(("127.0.0.1", base + off))
            except OSError:
                for s in socks:
                    s.close()
                continue
            held += socks
            out.append(base)
        raise OSError(f"no {n} loopback ports free with offsets {offsets}")
    finally:
        for s in held:
            s.close()


def _chain_link(h: str, v: str) -> str:
    import hashlib

    return hashlib.sha256((h + v).encode("utf-8")).hexdigest()


def _http(url: str, payload=None, timeout: float = 60.0):
    """GET (no payload) or POST a JSON payload; (status, content type, body)."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def phase_sharded(device, server: dict = None, rows: int = SERVER["G"],
                  label: str = "sharded") -> dict:
    """``ReconfigurableNode`` AR0..AR2 (each the accept/route parent of
    ``SHARDED_WORKERS`` worker processes on the card, ``serving/``) and
    RC0..RC2 in this process, on loopback ports, configured by properties
    alone (``ENGINE_ROWS`` split across each node's workers, HashChainApp
    by ``APPLICATION``); ``ReconfigurableAppClient``: batched creates,
    requests, the HTTP fronts, deletes, each checked; every worker's
    launches, ticks and card memory from the ``stats`` admin op."""
    import numpy as np

    from gigapaxos_tpu_torch.clients import PaxosClientAsync
    from gigapaxos_tpu_torch.clients.reconfigurable_client import ReconfigurableAppClient
    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.paxos_config import PC
    from gigapaxos_tpu_torch.reconfigurable_node import ReconfigurableNode
    from gigapaxos_tpu_torch.serving import shard_of_name, worker_address
    from gigapaxos_tpu_torch.serving.router import ShardedActiveNode
    from gigapaxos_tpu_torch.utils.config import Config

    n_w, n_ar, n_rc = SHARDED_WORKERS, SERVER["R"], RC["R"]
    off_w = Config.get_int(PC.SERVING_WORKER_PORT_OFFSET)
    ports = node_ports(n_ar + n_rc, (0, Config.get_int(PC.HTTP_PORT_OFFSET))
                       + tuple(off_w + w for w in range(n_w)))
    for i in range(n_ar):
        Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
    for i in range(n_rc):
        Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[n_ar + i]}")
    Config.set("SERVING_WORKERS", str(n_w))
    Config.set("ENGINE_ROWS", str(rows))
    want = (rows // n_w, SERVER["W"], SERVER["K"], SERVER["R"])
    if dict(zip("GWKR", want)) not in STEP_SHAPES.values():
        fail(f"{label}: workers at {want}, a shape phases 1-2 do not check")
    Config.set("SLOT_WINDOW", str(SERVER["W"]))
    Config.set("APPLICATION", "gigapaxos_tpu_torch.models.apps.HashChainApp")
    te.reset_launch_counts()
    t_phase = time.perf_counter()
    step_log = lambda what: log(f"{label}: [{time.perf_counter() - t_phase:.1f} s] {what}")
    nodes, client, admin = [], None, None
    try:
        for i in range(n_ar):
            nodes.append(ReconfigurableNode(f"AR{i}", HashChainApp, device=device))
        for i in range(n_rc):
            nodes.append(ReconfigurableNode(f"RC{i}", HashChainApp, device=device))
        parents = [n.servers[0] for n in nodes[:n_ar]]
        if not all(isinstance(p, ShardedActiveNode) and p.device.type == device.type
                   for p in parents):
            fail(f"{label}: the actives are {[type(p).__name__ for p in parents]}")
        rcs = [n.servers[0] for n in nodes[n_ar:]]
        # every node's workers boot together (each worker imports torch,
        # opens its own CUDA context and allocates its engine)
        errs = []

        def start(n):
            try:
                n.start()
            except Exception as e:  # reported below, the phase fails
                errs.append(f"{n.name}: {e!r}")

        threads = [threading.Thread(target=start, args=(n,)) for n in nodes]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            fail(f"{label}: boot failed: {errs}")
        step_log(f"{n_ar} actives x {n_w} workers and {n_rc} reconfigurators listening")
        admin = PaxosClientAsync([("127.0.0.1", ports[i]) for i in range(n_ar)])

        def stats_all():
            out = []
            for i in range(n_ar):
                st = admin.admin_sync(i, {"op": "stats"}, timeout=30)
                if not st or not st.get("ok"):
                    fail(f"{label}: stats of AR{i}: {st}")
                out.append(st)
            return out

        # readiness: the router's phase is the worst of its workers'
        deadline = time.time() + 120
        while True:
            sts = stats_all()
            if all(st["phase"] == "serving" for st in sts):
                break
            if time.time() > deadline:
                fail(f"{label}: not serving: {[st['serving'] for st in sts]}")
            time.sleep(0.5)
        # each worker's engine section (the parent cannot read a worker's
        # counters): its shape, launches and card memory
        engines = lambda key: [[w["engine"][key] for w in st["workers"]] for st in sts]
        shapes = {tuple(s) for per in engines("shape") for s in per}
        if shapes != {want}:
            fail(f"{label}: the workers' engines are {shapes}, expected {want} "
                 f"(the shape phases 1-2 hold the kernels at)")
        mem = engines("device_memory")
        step_log(f"every worker serving at {want}; card memory per worker "
                 f"(free, total, allocated bytes): {mem}")
        client = ReconfigurableAppClient.from_properties()

        # 1. batched creates
        names = [f"shn{i}" for i in range(SH_NAMES)]
        t0 = time.perf_counter()
        results = client.create_names(names, timeout=240)
        t_create = time.perf_counter() - t0
        bad = [nm for nm in names if not (results.get(nm) or {}).get("ok")]
        if bad:
            fail(f"{label}: {len(bad)} of {len(names)} creates failed, first "
                 f"{bad[0]}: {results.get(bad[0])}")
        step_log(f"{len(names)} batched creates in {t_create:.4f} s")
        owner = {nm: shard_of_name(nm, n_w) for nm in names}
        if set(owner.values()) != set(range(n_w)):
            fail(f"{label}: the names do not span every shard: {owner}")

        # 2. requests: SH_REQS_PER_NAME in sequence on each name, the names
        # in parallel; every response the next link of the name's chain
        chains = {nm: "" for nm in names}
        lat, errors = [], []
        lock = threading.Lock()

        def chain(nm: str) -> None:
            h = chains[nm]
            for k in range(SH_REQS_PER_NAME):
                v = f"s{k}"
                t1 = time.perf_counter()
                resp = client.send_request_sync(nm, v, timeout=120)
                dt = time.perf_counter() - t1
                h = _chain_link(h, v)
                with lock:
                    lat.append(dt)
                    if resp != h[:16]:
                        errors.append((nm, v, resp, h[:16]))
            chains[nm] = h

        sts0 = stats_all()
        ticks0 = [[w["tick"] for w in st["workers"]] for st in sts0]
        threads = [threading.Thread(target=chain, args=(nm,)) for nm in names]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        sts1 = stats_all()
        ticks1 = [[w["tick"] for w in st["workers"]] for st in sts1]
        # the host stages of one worker's tick (AR0's first) over the window
        stages = tick_stages_ms(sts0[0]["workers"][0]["profiler"]["counts"],
                                sts1[0]["workers"][0]["profiler"]["counts"])
        if errors:
            fail(f"{label}: {len(errors)} wrong responses, first {errors[0]}")
        ticks_per_s = [[(b - a) / wall for a, b in zip(t0_, t1_)]
                       for t0_, t1_ in zip(ticks0, ticks1)]
        step_log(f"{len(lat)} requests correct in {wall:.4f} s")

        # 3. every member of every name holds the same chain, on its shard
        def app_state(i, nm):
            r = admin.admin_sync(i, {"op": "app_state", "name": nm}, timeout=30)
            if not r or not r.get("ok"):
                fail(f"{label}: app_state {nm} at AR{i}: {r}")
            return r

        want_ck = lambda nm: json.dumps({"h": chains[nm], "n": SH_REQS_PER_NAME})
        deadline = time.time() + 60
        while True:
            bad = [(nm, i) for nm in names for i in range(n_ar)
                   if app_state(i, nm)["checkpoint"] != want_ck(nm)]
            if not bad or time.time() > deadline:
                break
            time.sleep(0.5)
        if bad:
            nm, i = bad[0]
            fail(f"{label}: {len(bad)} members differ, first {nm} at AR{i}: "
                 f"{app_state(i, nm)} expected {want_ck(nm)}")
        hosted = [[w["residency"]["active_names"] for w in st["workers"]]
                  for st in stats_all()]
        per_shard = [sum(1 for nm in names if owner[nm] == w) for w in range(n_w)]
        if any(h != per_shard for h in hosted):
            fail(f"{label}: names per worker {hosted}, expected {per_shard} on "
                 "every active")
        step_log(f"every member agrees; names per shard {per_shard} on every active")

        # 4. the HTTP fronts: a CREATE through RC0's, a request POSTed to
        # the owning worker's front on AR0, /stats and /metrics from both
        off = Config.get_int(PC.HTTP_PORT_OFFSET)
        rc_url = f"http://127.0.0.1:{ports[n_ar] + off}"
        if rcs[0]._http is None:
            fail(f"{label}: RC0 has no HTTP front (port taken)")
        code, _ct, body = _http(rc_url, {"type": "CREATE", "name": "shttp",
                                         "actives": list(range(n_ar))})
        if code != 200 or not json.loads(body).get("ok"):
            fail(f"{label}: HTTP create: {code} {body}")
        w_http = shard_of_name("shttp", n_w)
        host, wport = worker_address(("127.0.0.1", ports[0]), w_http)
        ar_url = f"http://{host}:{wport + off}"
        code, _ct, body = _http(ar_url, {"name": "shttp", "request": "via-http"})
        got = json.loads(body)
        if code != 200 or got.get("response") != _chain_link("", "via-http")[:16]:
            fail(f"{label}: HTTP request: {code} {got}")
        resp = client.send_request_sync("shttp", "binary", timeout=60)
        if resp != _chain_link(_chain_link("", "via-http"), "binary")[:16]:
            fail(f"{label}: the binary request after the HTTP one: {resp}")
        for url in (rc_url, ar_url):
            code, ct, body = _http(f"{url}/stats")
            if code != 200 or "stats" not in json.loads(body):
                fail(f"{label}: GET {url}/stats: {code} {body[:200]}")
            code, ct, body = _http(f"{url}/metrics")
            if code != 200 or "# delayprofiler " not in body:
                fail(f"{label}: GET {url}/metrics: {code} {body[:200]}")
        step_log("HTTP fronts: create, request, /stats and /metrics answered")

        # 5. deletes; every member frees the row
        deleted = names[:SH_DELETES]
        del_errors = []

        def delete(nm):
            ack = client.delete_name(nm, timeout=240)
            if not ack or not ack.get("ok"):
                with lock:
                    del_errors.append((nm, ack))

        threads = [threading.Thread(target=delete, args=(nm,)) for nm in deleted]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        t_delete = time.perf_counter() - t0
        if del_errors:
            fail(f"{label}: {len(del_errors)} deletes failed, first {del_errors[0]}")
        patience = 3 * Config.get_float(PC.DEACTIVATION_PERIOD_S)
        deadline = time.time() + patience
        while True:
            left = [(nm, i) for nm in deleted for i in range(n_ar)
                    if app_state(i, nm)["hosted"]]
            if not left or time.time() > deadline:
                break
            time.sleep(0.5)
        if left:
            fail(f"{label}: deleted names still hosted: {left[:4]}")
        sts = stats_all()
        hosted = [[w["residency"]["active_names"] for w in st["workers"]] for st in sts]
        live = [nm for nm in names if nm not in deleted] + ["shttp"]
        per_shard = [sum(1 for nm in live if shard_of_name(nm, n_w) == w)
                     for w in range(n_w)]
        if any(h != per_shard for h in hosted):
            fail(f"{label}: after the deletes names per worker {hosted}, "
                 f"expected {per_shard}")
        step_log(f"{len(deleted)} deletes in {t_delete:.4f} s; rows freed on every member")

        # 6. launches: every worker of every active launched gp_step
        worker_launches = engines("launches")
        for i, per in enumerate(worker_launches):
            for w, lc in enumerate(per):
                if not lc or lc.get("gp_step", 0) <= 0:
                    fail(f"{label}: worker {w} of AR{i} never launched gp_step: {lc}")
        parent = dict(te.LAUNCHES)
        launches = {k: parent[k] + sum(lc[k] for per in worker_launches for lc in per)
                    for k in parent}
        for k in ("gp_step", "gp_make_blob", "gp_create_groups", "gp_kill_groups"):
            if launches[k] <= 0:
                fail(f"{label}: {k} never launched: {launches}")
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        res = {
            "workers_per_active": n_w, "worker_shape": want,
            "creates": len(names), "create_seconds": t_create,
            "requests": len(lat), "req_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "ticks_per_s": ticks_per_s, "tick_stages_ms": stages,
            "deletes": len(deleted),
            "delete_seconds": t_delete, "device_memory": mem,
            "launches": launches, "parent_launches": parent,
            "worker_launches": worker_launches,
            "seconds": time.perf_counter() - t_phase,
        }
        beside = ""
        if server:
            beside = (f" (phase 6, 3 servers in one process: {server['req_per_s']:.6g} "
                      f"req/s, p50 {server['p50_ms']:.6g} ms, p99 "
                      f"{server['p99_ms']:.6g} ms, ticks/s per server "
                      f"{[round(t, 4) for t in server['ticks_per_s']]}; host "
                      f"stages of a server's tick at {SERVER['G']} rows, ms per "
                      f"tick: {server['tick_stages_ms']})")
        log(f"{label}: {len(lat)} requests over {len(names)} names on {n_ar} actives x "
            f"{n_w} workers: {res['req_per_s']:.6g} req/s, p50 {res['p50_ms']:.6g} ms, "
            f"p99 {res['p99_ms']:.6g} ms, ticks/s per worker "
            f"{[[round(t, 4) for t in per] for per in ticks_per_s]}; host stages "
            f"of AR0's first worker's tick at {want[0]} rows, ms per tick: "
            f"{stages}{beside}; "
            f"launches {launches}, per worker {worker_launches} "
            f"({res['seconds']:.1f} s)")
        return res
    finally:
        for c in (client, admin):
            if c is not None:
                c.close()
        for n in nodes:
            try:
                n.stop()
            except Exception as e:  # a node that never started
                log(f"{label}: stopping {n.name}: {e!r}")
        Config.clear()


def phase_txn(device) -> dict:
    """Sorted 2PC over Paxos on the card: a ``ManagerCluster`` of 3
    managers with ``TxnApp(StatefulAdderApp())`` at the server shape takes
    concurrent transfers over 2-4 groups each (exact conservation, equal
    balances on every member, no lock left); the coordinator-crash commit
    arm (journals in a temporary directory, every member crash-restarts,
    the resolver re-drives the commit); then one pinned seed of
    ``run_txn_soak`` at its own shape through the chaos sweep's ``main``."""
    import random
    import shutil

    from gigapaxos_tpu_torch.models.apps import StatefulAdderApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing import chaos_sweep
    from gigapaxos_tpu_torch.testing.clock import count_steps
    from gigapaxos_tpu_torch.testing.cluster import ManagerCluster
    from gigapaxos_tpu_torch.txn import (COMMITTED, TXN_COORD, Transaction, TxnApp,
                                         TxnDriver, TxnResolver, tx_op, txc_op)

    G, W, K, R = (SERVER[k] for k in ("G", "W", "K", "R"))
    cfg = te.EngineConfig(G, W, K, R)
    te.reset_launch_counts()
    t_phase = time.perf_counter()
    rng = random.Random(TXN_SEED)
    accounts = [f"acct{i}" for i in range(TXN_ACCOUNTS)]

    def make(**kw):
        c = ManagerCluster(cfg, lambda: TxnApp(StatefulAdderApp()), device=device, **kw)
        c.create(TXN_COORD)
        for nm in accounts:
            c.create(nm, initial_state=str(TXN_BALANCE))
        return c

    # 1. concurrent transfers
    c = make()
    try:
        steps = [0]
        clock = lambda: steps[0] * 0.05

        def submit(name, value, rid, cb):
            c.managers[rng.randrange(R)].propose(name, value, request_id=rid, callback=cb)

        def transfer():
            k = rng.randint(2, 4)
            names = rng.sample(accounts, k)
            amounts = [rng.randint(1, 9) for _ in names[1:]]
            ops = [(names[0], str(-sum(amounts)))] + [
                (nm, str(a)) for nm, a in zip(names[1:], amounts)]
            return TxnDriver(Transaction(ops, rng=rng), submit, TXN_COORD, clock,
                             prepare_timeout_s=4.0, retransmit_s=0.4, rng=rng)

        active, done = [], []
        todo = TXN_COUNT
        t0 = time.perf_counter()
        while todo or active:
            while todo and len(active) < TXN_INFLIGHT:
                active.append(transfer())
                todo -= 1
            for d in list(active):
                r = d.poll()
                if r is not None:
                    done.append((d, r))
                    active.remove(d)
            c.step_all()
            steps[0] += 1
            if steps[0] > 20_000:
                fail(f"txn: {len(active)} transactions undecided after 20,000 steps")
        wall = time.perf_counter() - t0
        committed = [(d, r) for d, r in done if r["outcome"] == COMMITTED]
        if not committed:
            fail(f"txn: none of {len(done)} transactions committed")
        want = {nm: TXN_BALANCE for nm in accounts}
        for d, _r in committed:
            for nm, dv in d.txn.ops:
                want[nm] += int(dv)
        deadline = time.time() + 60
        while True:
            views = [{nm: m.app.totals.get(nm) for nm in accounts} for m in c.managers]
            if all(v == want for v in views) or time.time() > deadline:
                break
            c.step_all()
        if not all(v == want for v in views):
            fail(f"txn: balances {views} differ from the committed history {want}")
        if sum(want.values()) != TXN_BALANCE * len(accounts):
            fail(f"txn: conservation breach: {want}")
        for m in c.managers:
            if m.app.locks or m.app.staged:
                fail(f"txn: locks left on member {m.my_id}: {m.app.locks} {m.app.staged}")
        transfers = {"txns": len(done), "committed": len(committed), "steps": steps[0],
                     "seconds": wall, "txn_per_s": len(done) / wall,
                     "ms_per_step": wall / steps[0] * 1e3}
        log(f"txn: {len(done)} transactions over 2-4 of {len(accounts)} groups, "
            f"{len(committed)} committed, {steps[0]} steps in {wall:.4f} s "
            f"({transfers['txn_per_s']:.6g} txn/s, {transfers['ms_per_step']:.6g} "
            "ms a step); balances conserved and equal on every member")
    finally:
        c.close()

    # 2. the coordinator-crash commit arm (tests/test_txn.py:287)
    tmp = tempfile.mkdtemp(prefix="gp_txn_")
    c = make(log_dirs=[os.path.join(tmp, f"n{r}") for r in range(R)], checkpoint_every=4)
    try:
        rid = [1 << 40]

        def send(name, value, max_steps=600):
            rid[0] += 1
            box = []
            for attempt in range(max_steps):
                if attempt % 40 == 0:
                    c.managers[0].propose(name, value, request_id=rid[0],
                                          callback=lambda r, resp: box.append(resp))
                if box:
                    return json.loads(box[-1])
                c.step_all()
            fail(f"txn: no decision for {name}: {value[:60]}")

        txid = "txcommitarm"
        ok = [send(TXN_COORD, txc_op("begin", txid, names=["acct0", "acct1"],
                                     ops=[["acct0", "5"], ["acct1", "7"]], t=0.0))["ok"],
              send("acct0", tx_op("prepare", txid, vals=["5"]))["ok"],
              send("acct1", tx_op("prepare", txid, vals=["7"]))["ok"],
              send(TXN_COORD, txc_op("prepared", txid))["ok"],
              send(TXN_COORD, txc_op("decide", txid, outcome=COMMITTED))["outcome"]
              == COMMITTED]
        if not all(ok):
            fail(f"txn: commit arm setup: {ok}")
        c.run(4)
        t0 = time.perf_counter()
        for r in range(R):
            c.restart(r)
        t_restart = time.perf_counter() - t0
        for m in c.managers:
            if m.app.locks.get("acct0") != txid or \
                    m.app.records[TXN_COORD][txid]["state"] != COMMITTED:
                fail(f"txn: replay on member {m.my_id} lost the transaction plane")
        steps = [0]

        def asubmit(name, value, rid_, cb):
            c.managers[0].propose(name, value, request_id=rid_, callback=cb)

        res_ = TxnResolver(asubmit, TXN_COORD, lambda: steps[0] * 0.05,
                           resolve_period_s=0.2, presume_abort_s=5.0, retransmit_s=0.2)
        for _ in range(4000):
            res_.poll()
            c.step_all()
            steps[0] += 1
            if res_.scans >= 3 and res_.idle():
                break
        else:
            fail(f"txn: the resolver never drained: {res_.live_records}")
        if res_.resolved_count != 1:
            fail(f"txn: resolved {res_.resolved_count} transactions, expected 1")
        for m in c.managers:
            if (m.app.totals.get("acct0"), m.app.totals.get("acct1")) != \
                    (TXN_BALANCE + 5, TXN_BALANCE + 7) or m.app.locks or m.app.staged:
                fail(f"txn: member {m.my_id} after the re-driven commit: "
                     f"{m.app.totals} {m.app.locks}")
        log(f"txn: coordinator-crash commit arm: 3 members restarted from their "
            f"journals in {t_restart:.4f} s, the resolver re-drove the commit in "
            f"{steps[0]} steps")
    finally:
        c.close()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(te.LAUNCHES)
    for k in ("gp_step", "gp_make_blob", "gp_create_groups", "gp_pack_rows"):
        if launches[k] <= 0:
            fail(f"txn: {k} never launched: {launches}")

    # 3. one pinned seed of the transaction soak at its own shape, through
    # the chaos sweep (one seed of the txn family)
    sweep_out = os.path.join(tempfile.mkdtemp(prefix="gp_sweep_"), "sweep.json")
    t0 = time.perf_counter()
    with count_steps() as counts:
        rc = chaos_sweep.main(["--family", "txn", "--base", str(TXN_SOAK_SEED),
                               "--count", "1", "--device", device.type,
                               "--out", sweep_out])
    with open(sweep_out) as f:
        sweep = json.load(f)
    shutil.rmtree(os.path.dirname(sweep_out), ignore_errors=True)
    seeds = [(e["family"], e["seed"], e["ok"]) for e in sweep["seeds"]]
    if rc != 0 or sweep["failed_seeds"] or seeds != [("txn", TXN_SOAK_SEED, True)]:
        fail(f"txn: the sweep of run_txn_soak({TXN_SOAK_SEED}): rc {rc}, "
             f"{json.dumps(sweep)[:3000]}")
    soak = {**sweep["seeds"][0], **counts, "platform": sweep["platform"],
            "seconds": time.perf_counter() - t0}
    log(f"txn: run_txn_soak({TXN_SOAK_SEED}) on the card through the chaos sweep: "
        f"{soak}; failed_seeds {sweep['failed_seeds']}")
    total = dict(te.LAUNCHES)
    return {"transfers": transfers, "restart_seconds": t_restart, "soak": soak,
            "launches": total, "seconds": time.perf_counter() - t_phase}


def phase_ledger(device) -> dict:
    """The bank-ledger workload through its ``main`` on the card at its
    published shape (``LEDGER``: 100,000 accounts on 131,072 rows, W=4,
    K=2, R=3; the transaction count cut): all four audits pass, at least
    one transaction commits, and the path launched gp_step (the generic
    instantiation), gp_make_blob, gp_create_groups and gp_pack_rows."""
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.scenarios import bank_ledger

    out = os.path.join(tempfile.mkdtemp(prefix="gp_ledger_"), "ledger.json")
    argv = ["--accounts", LEDGER["accounts"], "--txns", LEDGER["txns"],
            "--inflight", LEDGER["inflight"], "--zipf", LEDGER["zipf"],
            "--amount-max", LEDGER["amount_max"], "--replicas", LEDGER["replicas"],
            "--seed", LEDGER["seed"], "--device", device.type, "--out", out]
    te.reset_launch_counts()
    t0 = time.perf_counter()
    rc = bank_ledger.main([str(a) for a in argv])
    seconds = time.perf_counter() - t0
    launches = dict(te.LAUNCHES)
    if not os.path.exists(out):
        fail(f"ledger: main returned {rc} and wrote no document (stalled)")
    with open(out) as f:
        doc = json.load(f)
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    shape = LEDGER_ENGINE
    if rc != 0 or doc["audit"] != "pass" or doc["committed"] < 1:
        fail(f"ledger: rc {rc}, audit {doc['audit']}, {doc['committed']} committed: "
             f"{json.dumps(doc)[:3000]}")
    if doc["params"]["n_groups"] != shape["G"]:
        fail(f"ledger: ran on {doc['params']['n_groups']} rows, not {shape['G']}")
    for k in ("gp_step", "gp_make_blob", "gp_create_groups", "gp_pack_rows"):
        if launches[k] <= 0:
            fail(f"ledger: {k} never launched: {launches}")
    lat = doc["commit_latency_s"]
    log(f"ledger: {LEDGER['accounts']} accounts on {shape['G']} rows (W={shape['W']}, "
        f"K={shape['K']}, R={shape['R']}), {LEDGER['txns']} transactions at "
        f"{LEDGER['inflight']} in flight: {doc['committed']} committed, "
        f"{doc['aborted']} aborted, audit {doc['audit']}; boot {doc['boot_s']:.6g} s, "
        f"{doc['steps']} steps at {doc['ms_per_step']:.6g} ms a cluster step, "
        f"{doc['txns_per_s']} txn/s, commit p50 {lat['p50']:.6g} s p99 "
        f"{lat['p99']:.6g} s; launches {launches} (boot {doc['launches']['boot']}); "
        f"phase {seconds:.1f} s")
    return {"doc": doc, "launches": launches, "shape": shape, "seconds": seconds}


def phase_chaos(device) -> dict:
    """One pinned seed of each chaos family at the harness's own shapes on
    the card.  ``run_soak`` and ``run_density_soak`` run on the scripted
    clock of ``testing/clock.py`` in a child interpreter with
    ``PYTHONHASHSEED`` pinned, so that a seed replays one schedule on
    every call, and again on the CPU in another such child: the card's
    soak must give the CPU's result, ticks, steps and scripted seconds.
    ``run_sharded_soak`` (2 shards) has worker processes the clock cannot
    reach and runs on the wall clock here.  Any ``SoakDivergence`` fails
    the run."""
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing import chaos
    from gigapaxos_tpu_torch.testing.clock import count_steps, run_in_child

    replayed = ("result", "cluster_steps", "manager_ticks", "scripted_s")
    launches = {k: 0 for k in te.LAUNCHES}
    out = {}
    # the multistep seed's CPU run (host work only) goes on beside the
    # card's soaks, and is read after them
    ms = CHAOS_MULTISTEP
    ms_kw = dict(rounds=ms["rounds"],
                 config={"ENGINE_STEPS_PER_DISPATCH": ms["steps_per_dispatch"]})
    ms_cpu: dict = {}

    def cpu_multistep():
        try:
            ms_cpu["out"] = run_in_child("soak", ms["seed"], "cpu", **ms_kw)
        except RuntimeError as e:
            ms_cpu["error"] = e

    cpu_thread = threading.Thread(target=cpu_multistep, daemon=True)
    cpu_thread.start()
    for family, seed in (("soak", CHAOS_SEED), ("density_soak", CHAOS_DENSITY_SEED)):
        try:
            card = run_in_child(family, seed, device.type)
            cpu = run_in_child(family, seed, "cpu")
        except RuntimeError as e:
            fail(f"chaos: scripted {family} failed: {str(e)[-3000:]}")
        same = {k: card[k] for k in replayed} == {k: cpu[k] for k in replayed}
        if not same:
            fail(f"chaos: scripted {family} on the card {[card[k] for k in replayed]} "
                 f"differs from the CPU's {[cpu[k] for k in replayed]}")
        for k, v in card["launches"].items():
            launches[k] += v
        out[family] = {**card["result"], "clock": "scripted",
                       "cluster_steps": card["cluster_steps"],
                       "manager_ticks": card["manager_ticks"],
                       "scripted_s": card["scripted_s"], "seconds": card["seconds"],
                       "cpu_seconds": cpu["seconds"], "launches": card["launches"]}
        log(f"chaos: run_{family} on the card on the scripted clock: "
            f"{out[family]}; the CPU's run equal")

    # the multistep pinned seed at ENGINE_STEPS_PER_DISPATCH=4: every
    # dispatch of its managers one gp_step_n launch, under its faults
    try:
        card = run_in_child("soak", ms["seed"], device.type, **ms_kw)
    except RuntimeError as e:
        fail(f"chaos: scripted multistep soak failed: {str(e)[-3000:]}")
    cpu_thread.join()
    if "error" in ms_cpu:
        fail(f"chaos: scripted multistep soak on the CPU failed: "
             f"{str(ms_cpu['error'])[-3000:]}")
    cpu = ms_cpu["out"]
    if {k: card[k] for k in replayed} != {k: cpu[k] for k in replayed}:
        fail(f"chaos: scripted multistep soak on the card {[card[k] for k in replayed]} "
             f"differs from the CPU's {[cpu[k] for k in replayed]}")
    if card["launches"]["gp_step_n"] <= 0 or card["launches"]["gp_step"] != 0:
        fail(f"chaos: the multistep soak's dispatches were not one gp_step_n "
             f"launch each: {card['launches']}")
    for k, v in card["launches"].items():
        launches[k] += v
    out["soak_multistep"] = {**card["result"], "clock": "scripted",
                             "steps_per_dispatch": ms["steps_per_dispatch"],
                             "rounds": ms["rounds"],
                             "cluster_steps": card["cluster_steps"],
                             "manager_ticks": card["manager_ticks"],
                             "scripted_s": card["scripted_s"], "seconds": card["seconds"],
                             "cpu_seconds": cpu["seconds"], "launches": card["launches"]}
    log(f"chaos: run_soak({ms['seed']}, rounds={ms['rounds']}) at "
        f"ENGINE_STEPS_PER_DISPATCH={ms['steps_per_dispatch']} on the card on the "
        f"scripted clock: {out['soak_multistep']}; the CPU's run equal")

    te.reset_launch_counts()
    t0 = time.perf_counter()
    with count_steps() as counts:
        try:
            res = chaos.run_sharded_soak(CHAOS_SHARDED_SEED, workers=2, device=device)
        except chaos.SoakDivergence as e:
            fail(f"chaos: sharded_soak diverged: {str(e)[:2000]}")
    out["sharded_soak"] = {**res, **counts, "clock": "wall",
                           "seconds": time.perf_counter() - t0}
    log(f"chaos: run_sharded_soak on the card: {out['sharded_soak']}")
    for k, v in te.LAUNCHES.items():
        launches[k] += v
    for k in ("gp_step", "gp_step_n", "gp_make_blob", "gp_create_groups",
              "gp_kill_groups", "gp_restore_paused_rows", "gp_pack_rows"):
        if launches[k] <= 0:
            fail(f"chaos: {k} never launched: {launches}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 13: cold restart from a sharded checkpoint and a multi-file journal
# ---------------------------------------------------------------------------


def phase_recovery(device) -> dict:
    """``run_recovery`` at the probe's published defaults, uncut, with the
    eager baseline and a CPU restart of the same directory (module
    docstring)."""
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.recovery import RecoveryCheckFailed, run_recovery

    te.reset_launch_counts()
    try:
        res = run_recovery(**RECOVERY, eager_baseline=True, compare_cpu=True,
                           device=device, progress=lambda m: log(f"recovery: {m}"))
    except RecoveryCheckFailed as e:
        fail(f"recovery: {e}")
    launches = dict(te.LAUNCHES)
    rst = res["restart"]
    if res["journal_files"] < 2:
        fail(f"recovery: the journal spans {res['journal_files']} file(s), not 2+")
    if rst["leaves_differ_from_crashed"]:
        fail(f"recovery: restarted leaves differ from the crashed node's: "
             f"{rst['leaves_differ_from_crashed']}")
    for k in ("gp_step", "gp_make_blob"):
        if res["restart_launches"].get(k, 0) <= 0:
            fail(f"recovery: the restarted manager never launched {k}: "
                 f"{res['restart_launches']}")
    for k in ("gp_create_groups", "gp_step", "gp_make_blob"):
        if launches[k] <= 0:
            fail(f"recovery: {k} never launched: {launches}")
    res["launches"] = launches
    log(f"recovery: {res['names']} names on {res['g']} rows, {res['journal_files']} "
        f"journal files, {res['dir_bytes']} B on disk; create "
        f"{res['build']['create_s']:.6g} s, checkpoint {res['build']['checkpoint_s']:.6g} "
        f"s; restart to serving {rst['restart_to_serving_s']:.6g} s, first serve "
        f"{rst['time_to_first_serve_s']:.6g} s ({rst['phase_at_first_serve']}), full "
        f"hydration {rst['full_hydrate_s']:.6g} s, eager baseline "
        f"{res['eager_baseline_restart_s']:.6g} s, replay {rst['replay_s']:.6g} s "
        f"({rst['replay_segments']} segments, {rst['replay_blocks']} blocks); "
        f"{rst['names_checked']} names checked, {rst['names_wrong']} wrong; leaves "
        f"equal to the crashed node's and to a CPU restart's (CPU restart "
        f"{res['cpu_restart']['restart_s']:.6g} s); restarted manager's launches "
        f"{res['restart_launches']}; launches {launches}")
    return res


# ---------------------------------------------------------------------------
# phase 13b: the heal paths
# ---------------------------------------------------------------------------


class ShapeLog:
    """Every kernel shape launched while it is open: the wrappers of
    ``gp_kernels`` wrapped to note the step's (G, W, K, R), the blob's
    (G, W), each lifecycle op's (G, W, N) and the row pack's (NB, R)."""

    def __init__(self):
        self.step, self.blob, self.life, self.pack = set(), set(), set(), set()

    def __enter__(self):
        from gigapaxos_tpu_torch.ops import gp_kernels

        self.saved = {n: getattr(gp_kernels, n) for n in
                      ("step", "make_blob_rows", "_lifecycle_launch", "_pack_launch")}
        sv = self.saved
        names = {v: k for k, v in vars(gp_kernels).items()
                 if k.startswith("OP_") and isinstance(v, int)}

        def step(*a, **kw):
            cfg = kw["cfg"] if "cfg" in kw else a[6]
            self.step.add((cfg.n_groups, cfg.window, cfg.req_lanes, cfg.n_replicas))
            return sv["step"](*a, **kw)

        def make_blob_rows(states, *a, **kw):
            self.blob.add(tuple(int(x) for x in states.acc_bal.shape[-2:]))
            return sv["make_blob_rows"](states, *a, **kw)

        def life(a):
            self.life.add((names[int(a.op)], int(a.G), int(a.W), int(a.N)))
            return sv["_lifecycle_launch"](a)

        def pack(a):
            self.pack.add((int(a.NB), int(a.R)))
            return sv["_pack_launch"](a)

        for n, f in (("step", step), ("make_blob_rows", make_blob_rows),
                     ("_lifecycle_launch", life), ("_pack_launch", pack)):
            setattr(gp_kernels, n, f)
        return self

    def __exit__(self, *exc):
        from gigapaxos_tpu_torch.ops import gp_kernels

        for n, f in self.saved.items():
            setattr(gp_kernels, n, f)

    def unchecked(self) -> dict:
        """The shapes launched that the parity lists (``STEP_SHAPES``,
        ``LIFE_SHAPES``, ``PACK_SHAPES``) do not hold against the plain
        version."""
        steps = {tuple(d[k] for k in "GWKR") for d in STEP_SHAPES.values()}
        lives = {(G, W, n) for G, W, Ns in LIFE_SHAPES.values() for n in Ns}
        packs = {(4 * G * (1 + W), R) for G, W, R in PACK_SHAPES.values()}
        return {"step": sorted(self.step - steps),
                "blob": sorted(self.blob - {(g, w) for g, w, _k, _r in steps}),
                "life": sorted(x for x in self.life if x[1:] not in lives),
                "pack": sorted(self.pack - packs)}


def heal_commit_units(device) -> dict:
    """``tests/test_commit_heal.py``'s ack matrix and RESUME heal shapes on
    one active's manager at the server shape: an active acks an epoch
    commit ok only when it runs that epoch at the winning row, and a
    committed resume start heals each missing shape."""
    from gigapaxos_tpu_torch.manager import PaxosManager
    from gigapaxos_tpu_torch.models.apps import StatefulAdderApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.reconfiguration.active_replica import ActiveReplica
    from gigapaxos_tpu_torch.reconfiguration.coordinator import PaxosReplicaCoordinator

    cfg = te.EngineConfig(*(SERVER[k] for k in ("G", "W", "K", "R")))

    def make_ar():
        mgr = PaxosManager(0, StatefulAdderApp(), cfg, device=device)
        sent = []
        ar = ActiveReplica(0, PaxosReplicaCoordinator(mgr.app, mgr),
                           lambda dst, kind, body: sent.append((dst, kind, body)))
        return ar, mgr, sent

    def commit(ar, name, epoch, row):
        ar.handle_message("epoch_commit", {"name": name, "epoch": epoch, "row": row,
                                           "rc": ["RC", 0]})

    def last_ack(sent):
        acks = [b for (_d, k, b) in sent if k == "ack_epoch_commit"]
        if not acks:
            fail("heal commit: no ack sent")
        return acks[-1]

    def check(ok, what):
        if not ok:
            fail(f"heal commit: {what}")

    ar, mgr, sent = make_ar()
    mgr.create_paxos_instance("a", [0, 1, 2], row=3, pending=True)
    commit(ar, "a", 0, 3)
    check(last_ack(sent)["ok"] and 3 not in mgr.pending_rows, "live pending row not acked")
    mgr.create_paxos_instance("b", [0, 1, 2], row=4, pending=True)
    commit(ar, "b", 0, 6)
    ack = last_ack(sent)
    check(not ack["ok"] and ack["reason"] == "missing" and 4 in mgr.pending_rows,
          f"losing pending row: {ack}")
    commit(ar, "ghost", 0, 7)
    check(last_ack(sent)["reason"] == "missing", "ghost not missing")
    mgr.create_paxos_instance("c", [0, 1, 2], row=5)
    check(mgr.pause_group("c", 0) == "ok", "pause")
    commit(ar, "c", 0, 5)
    check(not last_ack(sent)["ok"], "paused member acked ok")
    mgr.create_paxos_instance("d", [0, 1, 2], row=6)
    mgr.propose_stop("d")
    st = mgr.state
    stopped = st.stopped.clone()
    stopped[6] = 1
    mgr.state = st._replace(stopped=stopped)
    mgr.create_paxos_instance("d", [0, 1, 2], row=7, version=1)
    commit(ar, "d", 0, 6)
    check(last_ack(sent)["ok"], "historic round not acked")
    acks = [b for (_d, k, b) in sent if k == "ack_epoch_commit"]
    mgr.close()

    ar, mgr, sent = make_ar()

    def heal(name, epoch, row, initial=None):
        ar.handle_message("start_epoch", {
            "name": name, "epoch": epoch, "actives": [0, 1, 2], "row": row,
            "initial_state": initial, "prev_actives": [], "prev_epoch": -1,
            "resume": True, "committed": True, "rc": ["RC", 0]})

    mgr.create_paxos_instance("x", [0, 1, 2], row=1, pending=True)
    mgr.propose("x", "5")
    heal("x", 0, 2)
    check(mgr.names["x"] == 2 and 2 not in mgr.pending_rows and mgr.queues.get(2),
          "re-home of a losing pending row")
    mgr.create_paxos_instance("y", [0, 1, 2], row=3)
    check(mgr.pause_group("y", 0) == "ok", "pause y")
    heal("y", 0, 4)
    check(mgr.names["y"] == 4 and ("y", 0) not in mgr.paused, "restore of a paused member")
    heal("z", 0, 5, initial="7")
    check(mgr.names["z"] == 5 and mgr.app.totals.get("z") == 7, "empty join")
    for nm, row in (("x", 2), ("y", 4), ("z", 5)):
        commit(ar, nm, 0, row)
        check(last_ack(sent)["ok"], f"{nm} not acked after its heal")
    mgr.close()
    return {"acks": [(b["name"], b["ok"], b.get("reason")) for b in acks]}


def heal_cluster(device):
    """A ManagerCluster of 3 managers at the server shape, and the name
    its scenario drives: the first of svc, svc0, svc1, ... whose row's
    initial coordinator is replica 1, as "svc"'s is in the reference
    tests' 8-row and 4-row engines (a stepped cluster's failure detector
    never fires, so a scenario that cuts replica 2 off must not have it
    coordinate)."""
    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.cluster import ManagerCluster

    cfg = te.EngineConfig(*(SERVER[k] for k in ("G", "W", "K", "R")))
    c = ManagerCluster(cfg, HashChainApp, device=device)
    name = next(nm for nm in ["svc"] + [f"svc{i}" for i in range(64)]
                if c.managers[0].default_row_for(nm) % cfg.n_replicas == 1)
    return c, name


def heal_until(c, cond, what, step=None) -> int:
    """Step ``c`` until ``cond()``, within the step cap and the wall
    budget; returns the steps taken."""
    step = step or c.step_all
    t0 = time.perf_counter()
    for n in range(HEAL_MAX_STEPS):
        if cond():
            return n
        if time.perf_counter() - t0 > HEAL_DEADLINE_S:
            break
        step()
    if cond():
        return HEAL_MAX_STEPS
    fail(f"heal: {what} not reached in {n} steps "
         f"({time.perf_counter() - t0:.1f} s)")


def heal_frontier(device, majority_behind: bool) -> dict:
    """``tests/test_frontier_stall_heal.py``: a member stranded 2 slots
    behind the majority after the decisions it needs left every ring
    heals by the state pull and the small-gap jump (``gp_jump_rows``);
    ``majority_behind``: the inverted shape, two members blank-rejoined
    at frontier 0 behind one resumed member."""
    import numpy as np

    from gigapaxos_tpu_torch.testing.cluster import DELIVER, DROP

    c, svc = heal_cluster(device)
    try:
        c.create(svc, members=[0, 1, 2])
        row = c.managers[0].names[svc]
        ex = lambda r: int(c.managers[r]._np("exec_slot")[row])
        apps = lambda: [m.app.state.get(svc) for m in c.managers]
        dead = None
        if not majority_behind:
            dead = np.full((3, 3), DELIVER)
            dead[2, :] = DROP
            dead[:, 2] = DROP
        done = {}
        for v in ("x1", "x2"):
            c.managers[0].propose(svc, v, callback=lambda r, resp: done.setdefault(r, resp))
        n_commit = heal_until(c, lambda: len(done) == 2, "two commits",
                              lambda: c.step_all(delivery=dead))
        epoch = c.managers[0].current_epoch(svc)
        if majority_behind:
            m = c.managers[2]
            if m.pause_group(svc, epoch, force=True) != "ok" or \
                    not m.resume_group(svc, epoch, [0, 1, 2], row, pending=False):
                fail("heal frontier: pause/resume of member 2")
            for r in (0, 1):
                m = c.managers[r]
                if not (m.kill(svc) and m.create_paxos_instance(
                        svc, [0, 1, 2], row=row, version=epoch)):
                    fail(f"heal frontier: blank re-join of member {r}")
        else:
            for m in c.managers[:2]:
                if m.pause_group(svc, epoch, force=True) != "ok" or \
                        not m.resume_group(svc, epoch, [0, 1, 2], row, pending=False):
                    fail("heal frontier: majority pause/resume")
        c.blobs = [m.blob() for m in c.managers]
        n_heal = heal_until(
            c, lambda: all(ex(r) >= 2 for r in range(3)) and len(set(apps())) == 1
            and None not in apps(), "the straggler's heal")
        done2 = {}
        c.managers[0].propose(svc, "x3", callback=lambda r, resp: done2.setdefault(r, resp))
        heal_until(c, lambda: bool(done2) and len(set(apps())) == 1, "new traffic")
        return {"name": svc, "row": row, "commit_steps": n_commit, "heal_steps": n_heal,
                "frontiers": [ex(r) for r in range(3)]}
    finally:
        c.close()


def heal_final_state(device) -> dict:
    """``tests/test_final_state_guard.py``: the epoch-final-state fallback
    stays silent on a member whose app lags its device frontier, and the
    caught-up coordinator serves the full history with its dedup set."""
    from gigapaxos_tpu_torch.reconfiguration.active_replica import ActiveReplica
    from gigapaxos_tpu_torch.reconfiguration.coordinator import PaxosReplicaCoordinator

    c, svc = heal_cluster(device)
    try:
        c.create(svc, members=[0, 1, 2])
        sent = []
        ars = [ActiveReplica(r, PaxosReplicaCoordinator(c.managers[r].app, c.managers[r]),
                             lambda dst, kind, body: sent.append((dst, kind, body)))
               for r in range(3)]
        coord = c.managers[0].coordinator_of_row(c.managers[0].names[svc])
        lag = (coord + 1) % 3
        m1 = c.managers[lag]
        real = m1.on_host_message
        m1.on_host_message = lambda kind, body: None if kind in (
            "payloads", "state_reply") else real(kind, body)
        c.submit(svc, "tail-request", entry=coord)
        c.run(10)
        c.submit(svc, "", entry=coord, stop=True, callback=None)
        c.run(10)
        row = m1.names[svc]
        if int(m1._np("stopped")[row]) != 1 or not m1.is_stopped(svc) \
                or m1.app_caught_up(svc):
            fail("heal final state: the lagging member's shape")
        ask = {"name": svc, "epoch": 0, "from": 2}
        ars[lag]._handle_request_final_state(dict(ask))
        if [m for m in sent if m[1] == "epoch_final_state"]:
            fail("heal final state: a lagging member served a truncated state")
        m0 = c.managers[coord]
        ars[coord]._handle_request_final_state(dict(ask))
        served = [m for m in sent if m[1] == "epoch_final_state"]
        if not served or served[0][2]["state"] != m0.app.checkpoint(svc) \
                or not served[0][2]["dedup"]:
            fail(f"heal final state: the caught-up member served {served}")
        m1.on_host_message = real
        c.run(30)
        caught = m1.app_caught_up(svc)
        if caught:
            sent.clear()
            ars[lag]._handle_request_final_state(dict(ask))
            s2 = [m for m in sent if m[1] == "epoch_final_state"]
            if not s2 or s2[0][2]["state"] != served[0][2]["state"]:
                fail("heal final state: the caught-up laggard served another state")
        return {"name": svc, "lag": lag, "laggard_caught_up": caught}
    finally:
        c.close()


def heal_rc_cluster(device, **kw):
    """A ReconfigurableCluster at the actives' and reconfigurators' shapes
    (phase 7's)."""
    from gigapaxos_tpu_torch.models.apps import HashChainApp
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.testing.rc_cluster import ReconfigurableCluster

    return ReconfigurableCluster(te.EngineConfig(*(AR[k] for k in ("G", "W", "K", "R"))),
                                 te.EngineConfig(*(RC[k] for k in ("G", "W", "K", "R"))),
                                 HashChainApp, device=device, **kw)


def heal_create(c, name, actives) -> None:
    c.client_request("create_service", {"name": name, "actives": actives})
    ack = c.wait_for("create_ack", max_steps=200)
    if not ack or not ack.get("ok"):
        fail(f"heal: create {name}: {ack}")


def heal_ready_audit(device) -> dict:
    """``tests/test_commit_heal.py``'s READY audit: a member that lost its
    row after the commit round is re-joined by the audit's committed
    resume and converges."""
    c = heal_rc_cluster(device)
    try:
        for rc in c.reconfigurators:
            rc.REDRIVE_EVERY = 4
            rc.ready_audit_period_s = 0.3
        for ar in c.active_replicas:
            ar.pause_option = False
        heal_create(c, "pl", [0, 1, 2])
        done = {}
        c.ars.managers[0].propose("pl", "w", callback=lambda rid, r: done.setdefault(rid, r))
        heal_until(c, lambda: bool(done), "the first request", c.step)
        m2 = c.ars.managers[2]
        if not m2.kill("pl") or m2.names.get("pl") is not None:
            fail("heal audit: row loss")
        n = heal_until(c, lambda: m2.names.get("pl") is not None, "the audit's re-join",
                       c.step)
        heal_until(c, lambda: len({m.app.state.get("pl") for m in c.ars.managers[:3]}) == 1,
                   "convergence after the re-join", c.step)
        return {"rejoin_steps": n}
    finally:
        c.close()


def heal_failover(device) -> dict:
    """``tests/test_failover_demand.py``: the record's primary
    reconfigurator dies mid-migration; a secondary adopts the re-drive,
    the migration completes and the new epoch serves."""
    c = heal_rc_cluster(device)
    try:
        for rc in c.reconfigurators:
            rc.REDRIVE_EVERY = 4
        heal_create(c, "ha", [0, 1, 2])
        primary = c.reconfigurators[0].primary_of("ha")
        c.client_request("reconfigure", {"name": "ha", "new_actives": [1, 2, 3]}, rc=primary)
        c.run(3)
        c.dead_rcs.add(primary)
        c.msg_filter = lambda dst, kind, body: dst != ("RC", primary)
        dead = c.reconfigurators[primary]
        dead.tick = lambda now=None: None
        dead.handle_message = lambda *a, **k: None
        other = c.reconfigurators[(primary + 1) % 3]
        ready = lambda: (lambda r: r is not None and r.state.value == "READY"
                         and sorted(r.actives) == [1, 2, 3])(other.rc_app.get_record("ha"))
        n = heal_until(c, ready, "the secondary's migration", c.step)
        done = {}

        def serve():
            c.ars.managers[1].propose("ha", "post-failover",
                                      callback=lambda rid, r: done.setdefault(rid, r))
            c.step()

        heal_until(c, lambda: bool(done), "a request after the failover", serve)
        return {"migration_steps": n, "primary": primary}
    finally:
        c.close()


def heal_demand(device) -> dict:
    """``tests/test_failover_demand.py``: sustained load on a name
    auto-migrates it through the demand pipeline (a threshold profile
    that targets actives 1-3)."""
    from gigapaxos_tpu_torch.reconfiguration.demand import AbstractDemandProfile

    class HotSpotProfile(AbstractDemandProfile):
        THRESHOLD, TARGET = 12, [1, 2, 3]

        def __init__(self, name):
            super().__init__(name)
            self.total = 0

        def combine(self, report):
            self.total += int(report.get("count", 0))

        def reconfigure(self, cur_actives, all_actives):
            if self.total >= self.THRESHOLD:
                return [a for a in self.TARGET if a in all_actives]
            return None

        def just_reconfigured(self):
            self.total = 0

    c = heal_rc_cluster(device, demand_profile_cls=HotSpotProfile)
    try:
        for ar in c.active_replicas:
            ar.demand_report_period_s = 0.05
        heal_create(c, "hot", [0, 1, 2])
        i = [0]

        def load():
            i[0] += 1
            c.ars.managers[0].propose("hot", f"v{i[0]}")
            c.step()

        rec = lambda: c.reconfigurators[0].rc_app.get_record("hot")
        n = heal_until(c, lambda: rec().state.value == "READY"
                       and sorted(rec().actives) == [1, 2, 3], "the demand migration", load)
        if rec().epoch != 1:
            fail(f"heal demand: epoch {rec().epoch}")
        return {"migration_steps": n}
    finally:
        c.close()


def heal_placement(device) -> dict:
    """``tests/test_placement.py``: a hot name on three loaded actives is
    migrated by the placement plane onto the idle fourth."""
    from gigapaxos_tpu_torch.reconfiguration.placement import ProximateBalancePolicy
    from gigapaxos_tpu_torch.utils.config import Config

    class EagerBalancePolicy(ProximateBalancePolicy):
        MIN_REQUESTS = 24

    Config.set("PLACEMENT_MIN_RATE_RPS", "0.1")
    c = heal_rc_cluster(device, placement_policy_cls=EagerBalancePolicy)
    try:
        for ar in c.active_replicas:
            ar.demand_report_period_s = 0.05
        for rc in c.reconfigurators:
            rc.echo_probe_period_s = 0.1
        for name in [f"bg{i}" for i in range(6)] + ["hx"]:
            heal_create(c, name, [0, 1, 2])
        i = [0]

        def load():
            i[0] += 1
            c.ars.managers[0].propose("hx", f"v{i[0]}")
            c.step()

        rec = lambda: c.reconfigurators[0].rc_app.get_record("hx")
        n = heal_until(c, lambda: rec().state.value == "READY" and rec().epoch >= 1
                       and 3 in rec().actives, "the placement migration", load)
        if len(rec().actives) != 3:
            fail(f"heal placement: {rec().to_json()}")
        return {"migration_steps": n, "actives": list(rec().actives)}
    finally:
        c.close()
        Config._cli.pop("PLACEMENT_MIN_RATE_RPS", None)


def phase_heal(device) -> dict:
    """The heal paths on the card at the deployed shapes: the commit-heal
    resume shapes and the READY audit, both frontier-stall scenarios, the
    final-state guard, the secondary reconfigurator's failover, the
    demand-driven migration and the placement plane's hot-name migration.
    Each scenario's own checks; its launches, the counts from 0 just
    before it; every kernel shape launched must be one that phases 2-3
    hold against the plain version; ``gp_jump_rows`` must launch."""
    from gigapaxos_tpu_torch.ops import engine as te

    scenarios = [
        ("commit_units", heal_commit_units),
        ("ready_audit", heal_ready_audit),
        ("frontier_small_gap", lambda d: heal_frontier(d, majority_behind=False)),
        ("frontier_majority_behind", lambda d: heal_frontier(d, majority_behind=True)),
        ("final_state", heal_final_state),
        ("failover", heal_failover),
        ("demand", heal_demand),
        ("placement", heal_placement),
    ]
    res, total = {}, {}
    t_phase = time.perf_counter()
    with ShapeLog() as shapes:
        for name, run in scenarios:
            t0 = time.perf_counter()
            te.reset_launch_counts()
            r = run(device)
            r["launches"] = {k: v for k, v in te.LAUNCHES.items() if v}
            r["kernel_launches"] = {k: v for k, v in te.KERNEL_LAUNCHES.items() if v}
            r["seconds"] = time.perf_counter() - t0
            for k, v in te.LAUNCHES.items():
                total[k] = total.get(k, 0) + v
            res[name] = r
            log(f"heal {name}: {json.dumps(r)}")
    missing = shapes.unchecked()
    if any(missing.values()):
        fail(f"heal: kernel shapes no parity phase checks: {missing}")
    for name in ("frontier_small_gap", "frontier_majority_behind"):
        if res[name]["launches"].get("gp_jump_rows", 0) < 1:
            fail(f"heal {name}: gp_jump_rows never launched: {res[name]['launches']}")
    for name, r in res.items():
        calls = r["launches"].get("gp_jump_rows", 0)
        if r["kernel_launches"].get("gp_jump_rows", 0) != calls:
            fail(f"heal {name}: gp_jump_rows not one kernel a call: "
                 f"{r['kernel_launches']} against {r['launches']}")
    res["launches"] = total
    res["shapes"] = {"step": sorted(shapes.step), "blob": sorted(shapes.blob),
                     "life": sorted(shapes.life), "pack": sorted(shapes.pack)}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"heal: every scenario passed in {res['seconds']:.1f} s; launches {total}; "
        f"shapes {res['shapes']}")
    return res


# ---------------------------------------------------------------------------
# phase 14: the mesh faces
# ---------------------------------------------------------------------------


def mesh_views(st, ref):
    """(shard, the global tensor's matching block) for every shard of the
    sharded tensor ``st``, its pad rows left out (see ShardedTensor)."""
    import numpy as np

    from gigapaxos_tpu_torch.parallel.mesh import GROUP_AXIS, REPLICA_AXIS

    gdim, Gs = st.gdim, st.shard_groups
    rdim = st.spec.index(REPLICA_AXIS) if REPLICA_AXIS in st.spec else None
    for idx in np.ndindex(*st.mesh.devices.shape):
        pos = dict(zip(st.mesh.axis_names, idx))
        g0 = pos[GROUP_AXIS] * Gs
        n = max(0, min(st.n_groups, g0 + Gs) - g0)
        if not n:
            continue
        block = ref.narrow(gdim, g0, n)
        if rdim is not None:
            block = block.narrow(rdim, pos[REPLICA_AXIS], 1)
        yield idx, st.shards[idx].narrow(gdim, 0, n), block


def mesh_held(diff: Diff, kernel: str, what: str, sharded, ref) -> None:
    """Every leaf of a sharded tree against a global tree, shard by shard."""
    for f in sharded._fields:
        for idx, a, b in mesh_views(getattr(sharded, f), getattr(ref, f)):
            diff.eq(kernel, f"{what}.{f}{list(idx)}", a, b)


def mesh_same(diff: Diff, kernel: str, what: str, a, b, i=None) -> None:
    """Two sharded trees on one mesh, shard for shard (``i``: substep i
    of ``a``'s [N, ...] leaves)."""
    import numpy as np

    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        for idx in np.ndindex(*x.mesh.devices.shape):
            sa = x.shards[idx] if i is None else x.shards[idx][i]
            diff.eq(kernel, f"{what}.{f}{list(idx)}", sa, y.shards[idx])


def mesh_rate(fn, states, req, want, steps: int, committed_of) -> tuple:
    """``steps`` steps of ``fn`` under the bench's load; replica 0's
    committed count summed on the device, one sync at the end.  Returns
    (committed, seconds, states)."""
    import torch

    total = torch.zeros((), dtype=torch.int64, device=want.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        states, out = fn(states, req, want)
        total += committed_of(out)
        del out
    n = int(total)
    return n, time.perf_counter() - t0, states


def mesh_packed(diff: Diff, device, bw: float, meshes: dict) -> dict:
    """The packed face over the meshes (``MESH_PACKED``): one replica's
    warm state, the packed gathered matrix of all R replicas (replica 2
    unheard), a request ring and an election pulse, heat on.  Each mesh
    face bit-equal to the one-device packed face (which phase 3's step
    shapes hold against the plain version at the server shape) and, where
    asked, to its own plain version; each logical device's launches (one
    ``gp_step``, at N > 1 one ``gp_step_n``, a dispatch, counted from 0
    before a dispatch of the mesh face); ms per dispatch beside the one-device face's; the slicing of
    the gathered matrix and the reassembly of ``out_rings`` and
    ``blob_vec`` timed against their bound (bytes read and written at
    the card's memory rate)."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.parallel import spmd as tspmd

    res = {}
    for label, dims, Ns, faces, with_plain in MESH_PACKED:
        t0 = time.perf_counter()
        G, W, K, R = (dims[k] for k in ("G", "W", "K", "R"))
        cfg = te.EngineConfig(G, W, K, R)
        req = torch.arange(1, K + 1, dtype=torch.int32, device=device)
        req = req[None, None, :].expand(R, G, K).contiguous()
        want_r = torch.zeros((R, G), dtype=torch.bool, device=device)
        stacked = tspmd.make_step(cfg, None, 1, donate=True, device=device)
        states = tspmd.build_replica_states(cfg, device=device)
        for _ in range(3):
            states, _ = stacked(states, req, want_r)
        my_id = 1
        gvec = gp_kernels.make_blob_rows(states, R)
        my = te.EngineState(*(x[my_id].contiguous() for x in states))
        del states, want_r
        heard = torch.tensor([True, True, False], device=device)[:R]
        want = torch.zeros(G, dtype=torch.bool, device=device)
        want[::16] = True
        heat = torch.arange(G, dtype=torch.int32, device=device) % 7
        out = res[label] = {"shape": dims, "faces": {}}
        for N in Ns:
            ring = req[my_id][None].expand(N, G, K).contiguous()
            one = tspmd.make_step(cfg, None, N, donate=False, io="packed_host",
                                  heat=True, device=device)
            ref = one(my, gvec, heard, ring, want, my_id, heat)
            out[f"one_device_ms_n{N}"] = cuda_ms(
                lambda: one(my, gvec, heard, ring, want, my_id, heat), MESH_PACKED_ITERS)
            for face in faces:
                mesh = meshes[face]
                fn = tspmd.make_step(cfg, mesh, N, donate=False, io="packed_host",
                                     heat=True)
                tag = f"mesh.packed.{label}.{face}.N{N}"
                te.reset_launch_counts()
                fn.reset_launches()
                k = fn(my, gvec, heard, ring, want, my_id, heat)
                torch.cuda.synchronize()
                launches = dict(te.LAUNCHES)
                per = {str(list(i)): dict(v) for i, v in fn.launches.items()}
                # one launch a dispatch on every device (gp_step_n at N > 1)
                kname = "gp_step" if N == 1 else "gp_step_n"
                if any(v != {kname: 1} for v in fn.launches.values()):
                    fail(f"{tag}: per-device launches {per}, expected one {kname} each")
                mesh_held(diff, kname, tag + ".state", k[0], ref[0])
                diff.eq(kname, tag + ".out_rings", k[1], ref[1])
                diff.eq(kname, tag + ".blob_vec", k[2], ref[2])
                for idx, a, b in mesh_views(k[3], ref[3]):
                    diff.eq(kname, f"{tag}.heat{list(idx)}", a, b)
                if with_plain:
                    p = fn.plain(my, gvec, heard, ring, want, my_id, heat)
                    mesh_same(diff, kname, tag + ".plain.state", k[0], p[0])
                    for j, what in ((1, "out_rings"), (2, "blob_vec")):
                        diff.eq(kname, f"{tag}.plain.{what}", k[j], p[j])
                    for idx in np.ndindex(*mesh.devices.shape):
                        diff.eq(kname, f"{tag}.plain.heat{list(idx)}",
                                k[3].shards[idx], p[3].shards[idx])
                    del p
                # a dispatch fed the sharded state and heat of the last one,
                # as a caller keeps them
                st_s, heat_s = k[0], k[3]
                ms = cuda_ms(lambda: fn(st_s, gvec, heard, ring, want, my_id, heat_s),
                             MESH_PACKED_ITERS)
                # the data movement alone: every device's slice of the
                # gathered matrix, and the reassembly of the outputs
                Gs = st_s.bal.shard_groups
                NB_s = te.blob_vec_len(cfg._replace(n_groups=Gs))
                M_s = te.out_vec_len(cfg._replace(n_groups=Gs))
                bufs = {i: torch.empty((R, NB_s), dtype=torch.int32, device=device)
                        for i in np.ndindex(*mesh.devices.shape)}
                n_of = lambda gi: max(0, min(G, gi * Gs + Gs) - gi * Gs)
                slice_ms = cuda_ms(lambda: [fn.slice_gathered(gvec, i[0] * Gs, n_of(i[0]),
                                                              Gs, b)
                                            for i, b in bufs.items()], MESH_PACKED_ITERS)
                n_g = mesh.shape["g"]
                rings = {gi: torch.empty((N, M_s), dtype=torch.int32, device=device)
                         for gi in range(n_g)}
                blobs = {gi: torch.empty((NB_s,), dtype=torch.int32, device=device)
                         for gi in range(n_g)}
                o_r, o_b = torch.empty_like(k[1]), torch.empty_like(k[2])

                def assemble():
                    fn.assemble(te.StepOutputs._fields, rings, o_r, Gs)
                    fn.assemble(te.Blob._fields, blobs, o_b, Gs)

                asm_ms = cuda_ms(assemble, MESH_PACKED_ITERS)
                slice_bytes = 2 * len(bufs) * R * NB_s * 4
                asm_bytes = 2 * (k[1].numel() + k[2].numel()) * 4
                out["faces"][f"{face}.N{N}"] = {
                    "mesh": dict(mesh.shape), "ms": ms, "launches": launches,
                    "per_device": per, "slice_ms": slice_ms, "slice_bytes": slice_bytes,
                    "slice_bound_ms": slice_bytes / bw * 1e3, "assemble_ms": asm_ms,
                    "assemble_bytes": asm_bytes, "assemble_bound_ms": asm_bytes / bw * 1e3,
                    "plain_checked": with_plain}
                f = out["faces"][f"{face}.N{N}"]
                log(f"{tag}: bit-equal to the one-device face"
                    + (" and to its plain version" if with_plain else "")
                    + f"; {ms:.6g} ms a dispatch (one device "
                    f"{out[f'one_device_ms_n{N}']:.6g} ms); slicing {slice_ms:.6g} ms vs "
                    f"bound {f['slice_bound_ms']:.6g} ms ({slice_bytes} B), reassembly "
                    f"{asm_ms:.6g} ms vs bound {f['assemble_bound_ms']:.6g} ms "
                    f"({asm_bytes} B); launches per device {per}")
                del k, st_s, heat_s, bufs, rings, blobs, o_r, o_b
            del ref, ring
        del my, gvec, req, heat, want
        torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
    return res


def phase_mesh(diff: Diff, device, bw: float, results: str) -> dict:
    """The mesh faces of make_step at the headline shape, every logical
    device on this card: the ('g',) face over 4 shards (and at a G that
    does not divide, padded) and the (g, r) face over 2 x 3, three steps
    (the first with an election pulse) bit for bit against the stacked
    face; a fault step of the (g, r) face against its plain version; N=4
    against four N=1 calls; the small shapes of the golden cases and the
    dry run against the CPU.  Then each face's committed dec/s beside the
    stacked face's, the (g, r) exchange's time against its bound, peak
    memory, and the entry points: the bench's multichip arm over the
    physical cards (its result to ``results``) and ``dryrun_multichip(8)``."""
    import numpy as np
    import torch

    from gigapaxos_tpu_torch import graft_entry
    from gigapaxos_tpu_torch.ops import engine as te
    from gigapaxos_tpu_torch.parallel import mesh as tmesh
    from gigapaxos_tpu_torch.parallel import spmd as tspmd
    from gigapaxos_tpu_torch.testing import bench

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    G, W, K, R = (MESH[k] for k in ("G", "W", "K", "R"))
    ng, nr = MESH_GR
    gmesh = tmesh.make_group_mesh(MESH_G_SHARDS, devices=[device] * MESH_G_SHARDS)
    grmesh = tmesh.make_mesh(nr, ng, devices=[device] * (ng * nr))
    res = {"shape": MESH, "g_mesh": dict(gmesh.shape), "gr_mesh": dict(grmesh.shape),
           "physical_devices": grmesh.physical_devices}

    def load(cfg):
        req = torch.arange(1, K + 1, dtype=torch.int32, device=device)
        req = req[None, None, :].expand(R, cfg.n_groups, K).contiguous()
        pulse = torch.zeros((R, cfg.n_groups), dtype=torch.bool, device=device)
        pulse[1, ::16] = True
        return req, pulse, torch.zeros_like(pulse)

    # 1. three steps of each face against the stacked face
    for G_run, faces in ((G, ("g", "gr")), (MESH_G_PADDED, ("g",))):
        cfg = te.EngineConfig(G_run, W, K, R)
        req, pulse, no_want = load(cfg)
        stacked = tspmd.make_step(cfg, None, 1, donate=False, device=device)
        fns = {"g": tspmd.make_step(cfg, gmesh, 1, donate=False),
               "gr": tspmd.make_step(cfg, grmesh, 1, donate=False)}
        ref = tspmd.build_replica_states(cfg, device=device)
        sts = {f: ref for f in faces}
        for t in range(3):
            want = pulse if t == 0 else no_want
            ref, ref_o = stacked(ref, req, want)
            for f in faces:
                sts[f], o = fns[f](sts[f], req, want)
                tag = f"mesh.{f}.G{G_run}.{t}"
                mesh_held(diff, "gp_step", tag + ".state", sts[f], ref)
                mesh_held(diff, "gp_step", tag + ".out", o, ref_o)
                del o
            del ref_o
        log(f"mesh G={G_run}: faces {faces} bit-equal to the stacked face over 3 "
            f"steps ({time.perf_counter() - t_phase:.1f} s)")
        if G_run != G:
            del sts, ref
            continue
        # 2. the (g, r) fault step against its plain version: replica 2
        # unheard, replica 0 pulsing for every group
        heard = torch.ones((R, R), dtype=torch.bool)
        heard[2, :] = False
        heard[:, 2] = False
        elect = torch.zeros((R, G), dtype=torch.bool, device=device)
        elect[0, :] = True
        gr = fns["gr"]
        k_st, k_o = gr(sts["gr"], req, elect, heard)
        p_st, p_o = gr.plain(sts["gr"], req, elect, heard)
        mesh_same(diff, "gp_step", "mesh.gr.fault.state", k_st, p_st)
        mesh_same(diff, "gp_step", "mesh.gr.fault.out", k_o, p_o)
        del p_st, p_o, k_o
        # 3. N=4 against four N=1 calls
        gr4 = tspmd.make_step(cfg, grmesh, 4, donate=False)
        ring = req[None].expand(4, R, G, K).contiguous()
        s4, o4 = gr4(k_st, ring, pulse)
        s1 = k_st
        for i in range(4):
            s1, o1 = gr(s1, req, pulse if i == 0 else no_want)
            mesh_same(diff, "gp_step", f"mesh.gr.n4.out{i}", o4, o1, i)
            del o1
        mesh_same(diff, "gp_step", "mesh.gr.n4.state", s4, s1)
        del s4, o4, s1, k_st, sts, ref, ring
        log(f"mesh: the (g, r) fault step bit-equal to its plain version, N=4 to "
            f"four N=1 calls ({time.perf_counter() - t_phase:.1f} s)")
    torch.cuda.empty_cache()

    # 4. the small shapes, on the card against the same meshes on the CPU
    cpu = torch.device("cpu")
    for name, d, kind, n_dev in MESH_SMALL:
        cfg = te.EngineConfig(d["G"], d["W"], d["K"], d["R"])
        meshes = []
        for dev in (device, cpu):
            if kind == "g":
                meshes.append(tmesh.make_group_mesh(n_dev, devices=[dev] * n_dev))
            else:
                meshes.append(tmesh.make_mesh(d["R"], n_dev, devices=[dev] * (n_dev * d["R"])))
        rng = np.random.default_rng(len(name))
        for N in (1, 4):
            k_fn, c_fn = (tspmd.make_step(cfg, m, N, donate=False) for m in meshes)
            k_st = c_st = tspmd.build_replica_states(cfg, device=cpu)
            for t in range(3):
                shape = (N, d["R"], d["G"], d["K"]) if N > 1 else (d["R"], d["G"], d["K"])
                req = np.where(rng.random(shape) < 0.6, rng.integers(1, 10 ** 6, shape),
                               -1).astype(np.int32)
                want = rng.random((d["R"], d["G"])) < (0.3 if t == 0 else 0.02)
                heard = rng.random((d["R"], d["R"])) < 0.85
                k_st, k_o = k_fn(k_st, req, want, heard)
                c_st, c_o = c_fn(c_st, req, want, heard)
                for f in k_st._fields:
                    diff.eq("gp_step", f"mesh.{name}.N{N}.{t}.{f}",
                            getattr(k_st, f).gather(cpu), getattr(c_st, f).gather())
                for f in k_o._fields:
                    diff.eq("gp_step", f"mesh.{name}.N{N}.{t}.out.{f}",
                            getattr(k_o, f).gather(cpu), getattr(c_o, f).gather())
    log(f"mesh small shapes {[m[0] for m in MESH_SMALL]}: card equal to the CPU "
        f"at N in (1, 4) ({time.perf_counter() - t_phase:.1f} s)")

    # 4b. the packed face over both meshes
    res["packed"] = mesh_packed(diff, device, bw, {"g": gmesh, "gr": grmesh})
    res["packed_launches"] = {}
    for shape in res["packed"].values():
        for f in shape["faces"].values():
            for k, v in f["launches"].items():
                res["packed_launches"][k] = res["packed_launches"].get(k, 0) + v
    log(f"mesh packed face: {[k for k in res['packed']]} "
        f"({time.perf_counter() - t_phase:.1f} s)")

    # 5. the main path: each face's rate under the bench's load, the counts
    # from 0 just before each timed run
    cfg = te.EngineConfig(G, W, K, R)
    req, _pulse, no_want = load(cfg)
    rates, launches = {}, {}
    stacked = tspmd.make_step(cfg, None, 1, donate=True, device=device)
    faces = {
        "stacked": (stacked, lambda o: o.n_committed[0].sum()),
        "g": (tspmd.make_step(cfg, gmesh, 1, donate=True),
              lambda o: sum(x[0].sum() for x in o.n_committed.shards.flat)),
        "gr": (tspmd.make_step(cfg, grmesh, 1, donate=True),
               lambda o: sum(o.n_committed.shards[gi, 0].sum() for gi in range(ng))),
    }
    for face, (fn, committed_of) in faces.items():
        states = tspmd.build_replica_states(cfg, device=device)
        f_req, f_want = req, no_want
        if face == "g":
            states, f_req, f_want = tspmd.shard_group_inputs(gmesh, cfg, states, req, no_want)
        elif face == "gr":
            states, f_req, f_want = tspmd.replicate_inputs(grmesh, states, req, no_want)
        _, _, states = mesh_rate(fn, states, f_req, f_want, MESH_WARM_STEPS, committed_of)
        te.reset_launch_counts()
        if face != "stacked":
            fn.reset_launches()
        n, sec, states = mesh_rate(fn, states, f_req, f_want, MESH_TIMED_STEPS,
                                   committed_of)
        launches[face] = dict(te.LAUNCHES)
        rates[face] = {"committed": n, "seconds": sec, "dec_per_s": n / sec}
        if face != "stacked":
            per = {str(list(k)): dict(v) for k, v in fn.launches.items()}
            # ('g',): the stacked face on each shard, one gp_step launch a
            # step; (g, r): a blob launch and a step launch a device
            want_per = ({"gp_step": MESH_TIMED_STEPS} if face == "g" else
                        {"gp_make_blob": MESH_TIMED_STEPS, "gp_step": MESH_TIMED_STEPS})
            if any(v != want_per for v in fn.launches.values()):
                fail(f"mesh {face}: per-device launches {per}, expected {want_per} each")
            launches[face]["per_device"] = per
        if n <= 0:
            fail(f"mesh {face}: no decisions committed")
        if face == "gr":
            assert_rsm(te.EngineState(*(x.gather() for x in states)))
            gr_states = states
        del states, f_req, f_want
    log(f"mesh rates over {MESH_TIMED_STEPS} steps (dec/s): "
        + ", ".join(f"{k} {v['dec_per_s']:.6g}" for k, v in rates.items())
        + f"; launches {launches}")

    # 6. the exchange: r(r-1) copies of a shard's blob rows per g-row, from
    # the (g, r) face's loaded states; each device's gp_make_blob held
    # against the plain version
    gr, states = faces["gr"][0], gr_states
    del gr_states
    Gs = states.bal.shard_groups
    NB = te.blob_vec_len(cfg._replace(n_groups=Gs))
    bufs = {}
    for idx in np.ndindex(ng, nr):
        bufs[idx] = torch.empty((R, NB), dtype=torch.int32, device=device)
        shard = te.EngineState(*(x.shards[idx][0] for x in states))
        gr.blob_into(shard, bufs[idx][idx[1]], idx)
        diff.eq("gp_make_blob", f"mesh.gr.blob{list(idx)}", bufs[idx][idx[1]],
                te.pack_blob(te.make_blob_plain(shard)))
    ex_ms = cuda_ms(lambda: gr.exchange(bufs), 10)
    ex_bytes = nr * (nr - 1) * ng * NB * 4
    ex_bound = 2 * ex_bytes / bw * 1e3
    peak = torch.cuda.max_memory_allocated()
    del bufs, states
    torch.cuda.empty_cache()
    log(f"mesh exchange: {ex_ms:.6g} ms per step for {ex_bytes} B of peer rows "
        f"(r(r-1) G 528 B), {100 * ex_bound / ex_ms:.4g}% of its bound {ex_bound:.6g} ms "
        f"(read and written at {bw:.3g} B/s); peak device memory {peak} B")

    # 7. the entry points
    te.reset_launch_counts()
    mc = bench.multichip(device)
    bench.write_out(os.path.join(results, "multichip.json"), mc)
    mc_launches = dict(te.LAUNCHES)
    te.reset_launch_counts()
    dry = graft_entry.dryrun_multichip(MESH_DRYRUN_DEVICES, device)
    dry_launches = dict(te.LAUNCHES)
    if mc_launches["gp_step"] <= 0 or dry_launches["gp_step"] <= 0:
        fail(f"mesh entry points: launches {mc_launches} {dry_launches}")
    n_dry = MESH_DRYRUN_DEVICES
    if dry["group_sharded"]["padded_groups"] != tspmd.padded_group_count(4 * n_dry + 3, n_dry) \
            or dry["dec_per_s"] <= 0:
        fail(f"mesh dry run: {dry}")
    seconds = time.perf_counter() - t_phase
    log(f"mesh entry points: bench multichip {json.dumps(mc['curve'])}; dry run "
        f"{json.dumps(dry)}; launches {mc_launches} {dry_launches}; phase "
        f"{seconds:.1f} s")
    res.update({"rates": rates, "launches": launches, "exchange_ms": ex_ms,
                "exchange_bytes": ex_bytes, "exchange_bound_ms": ex_bound,
                "peak_bytes": peak, "multichip": mc, "multichip_launches": mc_launches,
                "dryrun": dry, "dryrun_launches": dry_launches, "seconds": seconds})
    return res


# ---------------------------------------------------------------------------
# phase 15: the operating faces (launcher, capacity probe, trace collector)
# ---------------------------------------------------------------------------


def run_module(args: list, timeout: float, **env) -> subprocess.CompletedProcess:
    """``python -m <args>`` from the checkout, its output captured."""
    return subprocess.run([sys.executable, "-m"] + args, cwd=HERE, timeout=timeout,
                          capture_output=True, text=True, env={**os.environ, **env})


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def probe_summary(r: subprocess.CompletedProcess, what: str) -> dict:
    """The probe's summary line, its rounds and its nodes' launches."""
    lines = json_lines(r.stdout)
    summary = [ln for ln in lines if ln.get("metric") == "system_capacity_requests_per_s"]
    if r.returncode != 0 or not summary:
        fail(f"ops: {what}: rc {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    s = summary[-1]
    launches = {}
    for node in s["nodes"].values():
        for k, v in (node.get("launches") or {}).items():
            launches[k] = launches.get(k, 0) + v
    curve = [(ln["round"], ln["load_rps"], ln["response_rate"], ln["mean_latency_ms"],
              ln["p50_ms"], ln["p99_ms"], ln["sustained"]) for ln in s["rounds"][0]]
    return {"capacity_rps": s["value"], "unit": s["unit"], "warmup_s": s["warmup_s"],
            "rounds": s["rounds"][0], "launches": launches, "nodes": s["nodes"],
            "phases": next((ln["phases"] for ln in lines if "phases" in ln), None),
            "curve": curve}


def phase_ops(device, t_start: float, results: str) -> dict:
    """The deployment the way the README starts it, on the card: the
    port's scenario (free loopback ports, the nodes' default ENGINE_ROWS)
    booted by ``gigapaxos_tpu_torch.gp_server start all`` with the nodes'
    request tracers on (``GP_TRACE=1``); ``status all`` 6 up; the probe's
    ramp attached to it (round 0 must be answered at the reference's
    response rate; its latency is recorded); ``gp_trace`` over the
    actives (a merged timeline with a consensus hop, mean and p99 per
    hop); every node's launches and card memory (stats admin op: each
    launched gp_step); ``stop all`` and ``status all`` 6 down, no pid file
    and no process left.  Then the probe at its own defaults (6 processes
    at 64 rows; its capacity record to ``results``), and, when the call has
    time left, its in-process ramps with and without consensus."""
    from pathlib import Path

    from gigapaxos_tpu_torch.clients import PaxosClientAsync
    from gigapaxos_tpu_torch.gp_server import load_nodes, pid_alive, read_pid
    from gigapaxos_tpu_torch.obs import tracemerge
    from gigapaxos_tpu_torch.paxos_config import PC
    from gigapaxos_tpu_torch.utils.config import Config

    on_card = device.type == "cuda"
    # the host the six node processes share with this one: its load, and
    # this process's own CPU over an idle 2 s and its live threads (a
    # thread left busy by an earlier phase slows every node's tick)
    cpu0, t0 = time.process_time(), time.perf_counter()
    time.sleep(2.0)
    idle_cpus = (time.process_time() - cpu0) / (time.perf_counter() - t0)
    threads = sorted(t.name for t in threading.enumerate())
    log(f"ops: host load {os.getloadavg()}; this process busy {idle_cpus:.4f} CPUs "
        f"while idle, {len(threads)} threads {threads}")
    work = tempfile.mkdtemp(prefix="gp_ops_")
    ports = node_ports(6, (0, Config.get_int(PC.HTTP_PORT_OFFSET)))
    text = open(os.path.join(HERE, OPS_SCENARIO)).read()
    for old, new in zip(("21000", "21001", "21002", "22000", "22001", "22002"), ports):
        text = text.replace(f":{old}", f":{new}")
    # the nodes' default rows (65,536), the deployment phase 8 runs
    text = "\n".join(f"ENGINE_ROWS={OPS_ROWS}" if ln.startswith("ENGINE_ROWS=") else ln
                     for ln in text.splitlines())
    cfg = os.path.join(work, "ops.properties")
    with open(cfg, "w") as f:
        f.write(text + "\n")
    run_dir = os.path.join(work, "run")
    dev = ["--device", device.type]
    gp = ["gigapaxos_tpu_torch.gp_server", "--config", cfg, "--run-dir", run_dir]
    nodes = load_nodes(Path(cfg))
    out = {"ports": ports, "idle_cpus": idle_cpus, "threads": threads}
    started = False
    try:
        t0 = time.perf_counter()
        started = True
        r = run_module(gp + dev + ["start", "all"], 300, GP_TRACE="1")
        out["start_s"] = time.perf_counter() - t0
        if r.returncode != 0 or "up:" not in r.stdout:
            fail(f"ops: start all: rc {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-2000:]}")
        pids = {n: read_pid(Path(run_dir), n) for n in nodes}
        r = run_module(gp + ["status", "all"], 60)
        if r.returncode != 0 or r.stdout.count(": up") != 6:
            fail(f"ops: status all after start: rc {r.returncode}\n{r.stdout}")
        log(f"ops: start all: 6 nodes up in {out['start_s']:.4g} s (pids {pids}); "
            f"status all: {r.stdout.count(': up')} up")

        def stats(name):
            cli = PaxosClientAsync([nodes[name]])
            try:
                st = cli.admin_sync(0, {"op": "stats"}, timeout=30)
            finally:
                cli.close()
            if not st or not st.get("ok"):
                fail(f"ops: stats of {name}: {st}")
            return st

        actives = sorted(n for n in nodes if n.startswith("AR"))
        prof0 = {n: stats(n)["profiler"]["counts"] for n in actives}

        t0 = time.perf_counter()
        r = run_module(["gigapaxos_tpu_torch.testing.probe", "--attach", cfg] + dev +
                       ["--init-load", str(OPS_INIT_LOAD),
                        "--max-rounds", str(OPS_MAX_ROUNDS)], 900)
        att = probe_summary(r, "probe --attach")
        att["seconds"] = time.perf_counter() - t0
        out["attach"] = att
        log(f"ops: probe --attach at {OPS_ROWS} rows: capacity "
            f"{att['capacity_rps']} req/s; rounds (round, load, response rate, mean, "
            f"p50, p99 ms, sustained) {att['curve']}; phases {att['phases']}")
        # round 0 must be answered at the reference's response rate; its
        # mean latency against the reference's 1 s bar is recorded, not
        # gated: at these rows it is tick-bound (308-668 ms on an H100
        # 80GB HBM3 at 700 W once the tick stopped copying its 18 MB blob
        # frames on the host; 687-1,769 ms before), so a latency gate
        # would refuse a correct run on a slower host, as the wall clock
        # did phase 12
        r0 = att["rounds"][0] if att["rounds"] else None
        if r0 is None or r0["response_rate"] < OPS_ANSWERED:
            fail(f"ops: round 0 of the attached ramp not answered: {att['curve']}")
        log(f"ops: round 0 {'sustained' if r0['sustained'] else 'answered, over the latency bar'}"
            f" ({r0['response_rate']} answered, mean {r0['mean_latency_ms']} ms)")
        # each active's host stages of a tick over the ramp (ms per tick;
        # the rest of t_tick is work no stage names)
        out["tick_stages_ms"] = {n: tick_stages_ms(prof0[n], stats(n)["profiler"]["counts"])
                                 for n in actives}
        log(f"ops: host stages of a tick over the ramp, ms per tick: "
            f"{out['tick_stages_ms']}")

        r = run_module(["gigapaxos_tpu_torch.testing.gp_trace", "--props", cfg,
                        "--json"], 120)
        if r.returncode != 0:
            fail(f"ops: gp_trace: rc {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        doc = json.loads(r.stdout)
        traces = doc["traces"]
        full = [tr for tr in traces if any(h["phase"] == "consensus" for h in tr["hops"])]
        if not full:
            fail(f"ops: no merged timeline has a consensus hop ({len(traces)} traces "
                 f"from nodes {doc['nodes']})")
        out["trace"] = {"nodes": doc["nodes"], "traces": len(traces),
                        "with_consensus": len(full), "hops": doc["hops"]}
        log(f"ops: gp_trace over the actives {doc['nodes']}: {len(traces)} merged "
            f"timelines, {len(full)} with a consensus hop; per hop (n, mean ms, p99 ms) "
            + ", ".join(f"{k} ({v['n']}, {v['mean_ms']:.4g}, {v['p99_ms']:.4g})"
                        for k, v in doc["hops"].items()))
        log("ops: one merged timeline:\n" + tracemerge.render_trace(full[-1]))

        launches, memory = {}, {}
        for name in sorted(nodes):
            eng = stats(name).get("engine") or {}
            # (on the CPU a node runs the plain engine: no launches)
            if (eng.get("launches") or {}).get("gp_step", 0) <= 0 and on_card:
                fail(f"ops: {name} never launched gp_step: {eng.get('launches')}")
            for k, v in eng["launches"].items():
                launches[k] = launches.get(k, 0) + v
            memory[name] = {"shape": eng.get("shape"),
                            "gp_step": eng["launches"]["gp_step"],
                            "device_memory": eng.get("device_memory")}
        out["launches"], out["nodes"] = launches, memory
        log(f"ops: every node launched gp_step: {memory}; launches {launches}")
    finally:
        if started:
            r = run_module(gp + ["stop", "all"], 180)
    if r.returncode != 0:
        fail(f"ops: stop all: rc {r.returncode}\n{r.stdout}\n{r.stderr[-2000:]}")
    r = run_module(gp + ["status", "all"], 60)
    left = [n for n, p in pids.items() if pid_alive(p)]
    pidfiles = [f for f in os.listdir(run_dir) if f.endswith(".pid")]
    if r.returncode != 3 or r.stdout.count(": down") != 6 or left or pidfiles:
        fail(f"ops: after stop all: rc {r.returncode}, {r.stdout}; alive {left}; "
             f"pid files {pidfiles}")
    log(f"ops: stop all: status all {r.stdout.count(': down')} down, no pid file, "
        f"no process left")

    t0 = time.perf_counter()
    r = run_module(["gigapaxos_tpu_torch.testing.probe"] + dev +
                   ["--capacity-out", os.path.join(results, "probe_capacity.json"),
                    "--label", "defaults"], 900)
    dft = probe_summary(r, "probe at its defaults")
    dft["seconds"] = time.perf_counter() - t0
    out["probe"] = dft
    log(f"ops: probe at its defaults (6 processes at 64 rows): capacity "
        f"{dft['capacity_rps']} req/s in {dft['seconds']:.4g} s; rounds {dft['curve']}; "
        f"phases {dft['phases']}; launches {dft['launches']}")
    for k in ("gp_step", "gp_make_blob", "gp_create_groups"):
        if dft["launches"].get(k, 0) <= 0 and on_card:
            fail(f"ops: the probe's nodes never launched {k}: {dft['launches']}")

    spent = time.perf_counter() - t_start
    if spent < OPS_INPROC_BUDGET_S:
        for label, flags in (("in_process_unreplicated", ["--unreplicated"]),
                             ("in_process", [])):
            t0 = time.perf_counter()
            r = run_module(["gigapaxos_tpu_torch.testing.probe", "--in-process"] + dev + flags,
                           900)
            res = probe_summary(r, f"probe --in-process {' '.join(flags)}")
            res["seconds"] = time.perf_counter() - t0
            out[label] = res
            log(f"ops: probe --in-process {' '.join(flags)}: capacity "
                f"{res['capacity_rps']} req/s in {res['seconds']:.4g} s; rounds "
                f"{res['curve']}")
    else:
        log(f"ops: in-process ramps left out: {spent:.1f} s spent, past "
            f"{OPS_INPROC_BUDGET_S} s")
    shutil.rmtree(work, ignore_errors=True)
    return out


def phase_baseline(device, results: str) -> dict:
    """The port's perf-baseline reader over the bench results phases 3,
    14 and 15 wrote to ``results`` (the steady headline, the dispatch
    ablation, the multichip arm, the probe's capacity record at its
    defaults): the baseline document has every required series and sane
    bands (``validate``), the steady headline checked against its card's
    band is in band, and ``--check-only`` reads the document back."""
    from gigapaxos_tpu_torch.testing import perf_baseline as pb

    names = ("headline.json", "ablation.json", "multichip.json", "probe_capacity.json")
    missing = [n for n in names if not os.path.exists(os.path.join(results, n))]
    if missing:
        fail(f"baseline: no {missing} from the earlier phases (run headline, mesh "
             "and ops with it)")
    out = os.path.join(results, "baseline.json")
    rc = pb.main(["--root", results, "--out", out, "--fresh",
                  os.path.join(results, "headline.json"), "--device", device.type])
    with open(out) as f:
        doc = json.load(f)
    errs = pb.validate(doc)
    fc = doc.get("fresh_check") or {}
    if rc != 0 or errs or not fc.get("in_band"):
        fail(f"baseline: rc {rc}, problems {errs}, fresh check {fc}")
    if pb.main(["--check-only", out]) != 0:
        fail("baseline: --check-only refused the document it wrote")
    series = doc["series"]
    heads = series["committed_decisions_per_s"]
    log(f"baseline: {len(doc['sources'])} sources {doc['sources']}; headline bands "
        + ", ".join(f"{k}: {v['values']} lower {v['band']['lower']}"
                    for k, v in heads.items())
        + f"; capacity {list(series['system_capacity_requests_per_s'])}; ablation and "
        f"multichip cards {list(series['dispatch_ablation'].get('cards', {}))} "
        f"{list(series['multichip_weak_scaling'].get('cards', {}))}; state "
        f"{series['engine_state_bytes_per_group']['bytes_per_group']} B a group; "
        f"fresh check {fc['value']} >= {fc['band_lower']} ({fc['platform']}): in band")
    return {"fresh_check": fc, "sources": doc["sources"], "headline": heads}


def residency_kernels(diff: Diff, res: dict, abl: dict, chs: dict, on_paths) -> list:
    """The kernels line's entries of gp_step's N-substep modes (phase 3b):
    ``res`` phase 3b's result, ``abl`` the bench ablation's (the stacked
    N=8 arm launches gp_step_cluster), ``chs`` phase 12's."""
    nkeys = ("ms", "ms_events", "bound_ms", "n_launch_bound_ms", "share", "plain_ms",
             "ms_gp_step", "ms_n_launches", "route", "plan")
    by_n = lambda r: {n: {k: v[k] for k in nkeys if k in v} for n, v in r["by_n"].items()}
    srv8 = res["server_shape"]["by_n"][8]
    abl8 = res["ablation_stacked"]["by_n"][8]
    return [
        {
            "name": "gp_step_n", "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_step.cu",
            "replaces": "gigapaxos_tpu/parallel/spmd.py:257",
            "launches": res["launches"]["gp_step_n"], "launches_from": "residency",
            "launches_by_path": on_paths("gp_step_n"),
            "max_abs_err": diff.max_abs["gp_step_n"],
            "ms": srv8["ms"], "plain_ms": srv8["plain_ms"], "bound_ms": srv8["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "ms_events": srv8["ms_events"],
            "share": srv8["share"], "ms_n_launches": srv8["ms_n_launches"],
            "n_launch_bound_ms": srv8["n_launch_bound_ms"], "plan": srv8["plan"],
            "shape": dict(SERVER, N=8), "comparisons": diff.checked["gp_step_n"],
            "server_shape": by_n(res["server_shape"]),
            "headline_shape": by_n(res["headline_shape"]),
            "server_window": {k: res["server"][k] for k in (
                "req_per_s", "p50_ms", "p99_ms", "tick_stages_ms", "per_manager_launches",
                "requests", "post_restore_requests", "steps_per_dispatch")},
            "chaos_multistep_launches": chs["soak_multistep"]["launches"]["gp_step_n"],
        },
        {
            "name": "gp_step_cluster", "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_step.cu",
            "replaces": "gigapaxos_tpu/parallel/spmd.py:181",
            "launches": abl["launches"]["gp_step_cluster"], "launches_from": "bench",
            "launches_by_path": on_paths("gp_step_cluster"),
            "max_abs_err": diff.max_abs["gp_step_cluster"],
            "ms": abl8["ms"], "plain_ms": abl8["plain_ms"], "bound_ms": abl8["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "share": abl8["share"],
            "ms_n_launches": abl8["ms_n_launches"],
            "n_launch_bound_ms": abl8["n_launch_bound_ms"], "plan": abl8["plan"],
            "shape": dict(ABLATION, N=8), "comparisons": diff.checked["gp_step_cluster"],
            "ablation_shape": by_n(res["ablation_stacked"]),
            "server_shape": by_n(res["server_stacked"]),
        },
    ]


def residency_summary(res: dict, chs: dict, smi_line: str) -> str:
    """The report's summary line of phase 3b (and phase 12's multistep
    seed)."""
    pk = {lbl: {n: round(v["ms"], 6) for n, v in res[f"{lbl}_shape"]["by_n"].items()}
          for lbl in ("server", "headline")}
    nl = {lbl: {n: round(v["ms_n_launches"], 6) for n, v in res[f"{lbl}_shape"]["by_n"].items()
                if "ms_n_launches" in v} for lbl in ("server", "headline")}
    ab1 = res["ablation_stacked"]["by_n"][1]
    ab8 = res["ablation_stacked"]["by_n"][8]
    sv8 = res["server_stacked"]["by_n"][8]
    rsrv = res["server"]
    return (f"summary: residency: packed dispatch ms by N, one launch {pk}, N launches "
            f"{nl}; stacked N=1 at G={ABLATION['G']} one gp_step {ab1['ms']:.6g} ms "
            f"vs gp_make_blob + gp_step {ab1['ms_n_launches']:.6g} ms; "
            f"stacked N=8 one gp_step_cluster {ab8['ms']:.6g} "
            f"ms vs N launches {ab8['ms_n_launches']:.6g} ms (bound {ab8['bound_ms']:.6g} "
            f"ms), at G={SERVER['G']}, W={SERVER['W']} {sv8['ms']:.6g} ms vs "
            f"{sv8['ms_n_launches']:.6g} ms; servers at ENGINE_STEPS_PER_DISPATCH={RES_SERVER_N}: "
            f"{rsrv['req_per_s']:.6g} req/s p50 {rsrv['p50_ms']:.6g} ms p99 "
            f"{rsrv['p99_ms']:.6g} ms, ms per tick {rsrv['tick_stages_ms']}; chaos "
            f"multistep seed {CHAOS_MULTISTEP['seed']} "
            f"{chs['soak_multistep']['seconds']:.4g} s; phase {res['seconds']:.1f} s; "
            f"on {smi_line}")


def kernels_line(diff: Diff, head: dict, step_t: dict, life: dict, dens: dict,
                 xfer: dict, srv: dict, pack: dict, rcs: dict, rcn: dict,
                 shd: dict, txn: dict, ledger: dict, chs: dict, rec: dict,
                 heal: dict, mesh: dict, ops: dict, res: dict) -> list:
    """The kernels line's entries, from the phases' results."""
    srv_t, den_t = step_t["server"], step_t["density"]
    cap, abl = head["capacity"], head["ablation"]
    # the bench's capacity and ablation arms; the probe at its defaults
    # (its node processes' counts); the launcher's deployment (its six)
    bench_l = {k: cap["launches"][k] + abl["launches"][k] for k in cap["launches"]}
    # the mesh faces' timed runs and the entry points built on them
    mesh_runs = [mesh["launches"]["g"], mesh["launches"]["gr"],
                 mesh["multichip_launches"], mesh["dryrun_launches"],
                 mesh["packed_launches"]]
    mesh_l = {k: sum(r[k] for r in mesh_runs) for k in mesh["dryrun_launches"]}
    mesh_rec = lambda name: {
        "launches_g": mesh["launches"]["g"][name],
        "launches_gr": mesh["launches"]["gr"][name],
        "launches_multichip": mesh["multichip_launches"][name],
        "launches_dryrun": mesh["dryrun_launches"][name],
        "launches_packed": mesh["packed_launches"][name],
        "shape": mesh["shape"], "g_mesh": mesh["g_mesh"], "gr_mesh": mesh["gr_mesh"],
        "checked_small": [m[:2] for m in MESH_SMALL],
    }
    per_path = {"density": dens["launches_total"], "state_transfer": xfer["launches"],
                "server": srv["launches"], "rc_stepped": rcs["launches"],
                "reconfiguration": rcn["launches"], "sharded": shd["launches"],
                "txn": txn["launches"], "ledger": ledger["launches"],
                "chaos": chs["launches"],
                "recovery": rec["launches"], "heal": heal["launches"],
                "bench": bench_l, "mesh": mesh_l,
                "probe": ops["probe"]["launches"], "ops": ops["launches"],
                "residency": res["launches"]}
    on_paths = lambda name: {p: per_path[p].get(name, 0) for p in per_path}
    at_shape = lambda t, *keys: {k: t[k] for k in ("shape",) + keys}
    kernels = [
        {
            "name": "gp_step", "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_step.cu",
            "replaces": "gigapaxos_tpu/ops/engine.py:380",
            "launches": srv["launches"]["gp_step"],
            "max_abs_err": diff.max_abs["gp_step"],
            "launches_by_path": on_paths("gp_step"),
            "ms": srv_t["ms"], "plain_ms": srv_t["plain_ms"],
            "bound_ms": srv_t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "ms_events": srv_t["ms_events"],
            "ms_fresh_state": srv_t["ms_fresh"], "share": srv_t["share"],
            "plan": srv_t["plan"],
            "shape": SERVER, "comparisons": diff.checked["gp_step"],
            "headline": {
                "launches_steady": head["arms"]["steady"]["launches"]["gp_step"],
                "launches_failover": head["arms"]["failover"]["launches"]["gp_step"],
                "ms_per_replica_step": head["ms_per_replica_step"],
                "ms_per_replica_step_events": head["ms_per_replica_step_events"],
                "ms_per_replica_step_fresh_state":
                    head["ms_per_replica_step_fresh"],
                "ms_quiet": head["ms_quiet"], "share": head["share"],
                "bound_ms": head["bound_ms"], "plain_ms": head["plain_ms"],
                "plan": head["plan"],
            },
            "capacity": {
                "shape": CAPACITY, "launches": cap["launches"]["gp_step"],
                "record": cap["record"],
                **{k: cap.get(k) for k in ("ms_per_replica_step_events", "bound_ms")},
            },
            "ablation": {
                "shape": ABLATION, "launches": abl["launches"]["gp_step"],
                "arms": abl["result"]["arms"], "parity": abl["result"]["parity"],
            },
            "density_shape": {
                "shape": den_t["shape"],
                "launches": dens["launches_total"]["gp_step"],
                **{k: den_t[k] for k in ("ms", "ms_events", "ms_fresh", "bound_ms",
                                         "plain_ms", "share")},
            },
            "mesh": {**mesh_rec("gp_step"), "dec_per_s": {
                k: v["dec_per_s"] for k, v in mesh["rates"].items()},
                "exchange_ms": mesh["exchange_ms"],
                "exchange_bound_ms": mesh["exchange_bound_ms"],
                "exchange_bytes": mesh["exchange_bytes"],
                "packed": {label: {"one_device_ms": {k: v for k, v in r.items()
                                                     if k.startswith("one_device_ms")},
                                   **{f: {k: v[k] for k in (
                                       "ms", "slice_ms", "slice_bound_ms", "assemble_ms",
                                       "assemble_bound_ms", "per_device")}
                                      for f, v in r["faces"].items()}}
                           for label, r in mesh["packed"].items()}},
            **{f"{p}_shape": at_shape(step_t[p], "ms", "ms_events", "ms_fresh",
                                      "bound_ms", "plain_ms", "share", "plan")
               for p in ("ar", "rc", "worker", "recovery", "ledger")},
            "checked_shapes": {k: step_t[k]["shape"] for k in step_t},
        },
        {
            "name": "gp_make_blob", "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_step.cu",
            "replaces": "gigapaxos_tpu/ops/engine.py:277",
            "launches": srv["launches"]["gp_make_blob"],
            "launches_by_path": on_paths("gp_make_blob"),
            "max_abs_err": diff.max_abs["gp_make_blob"],
            "ms": srv_t["make_blob_ms"], "plain_ms": srv_t["make_blob_plain_ms"],
            "bound_ms": srv_t["make_blob_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": SERVER, "comparisons": diff.checked["gp_make_blob"],
            "headline": {
                "launches_steady": head["arms"]["steady"]["launches"]["gp_make_blob"],
                "launches_failover": head["arms"]["failover"]["launches"]["gp_make_blob"],
                "ms_per_replica": head["make_blob_ms"],
                "bound_ms": head["make_blob_bound_ms"],
            },
            "density_shape": {
                "shape": den_t["shape"],
                "launches": dens["launches_total"]["gp_make_blob"],
                "ms": den_t["make_blob_ms"], "plain_ms": den_t["make_blob_plain_ms"],
                "bound_ms": den_t["make_blob_bound_ms"],
            },
            "mesh": mesh_rec("gp_make_blob"),
            **{f"{p}_shape": at_shape(step_t[p], "make_blob_ms", "make_blob_ms_events",
                                      "make_blob_plain_ms", "make_blob_bound_ms")
               for p in ("ar", "rc", "worker", "recovery", "ledger")},
            "checked_shapes": {k: step_t[k]["shape"] for k in step_t},
        },
    ]
    kernels += residency_kernels(diff, res, abl, chs, on_paths)
    for name, _fn, ref, path in LIFE_KERNELS:
        t_srv, t_head = life[name]["server"], life[name]["headline"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/gp_lifecycle.cu",
            "replaces": ref,
            # the count of the path this kernel is checked on; the row ops
            # only tests use count their launches in the parity phase
            "launches": life[name]["parity_launches"] if path == "parity"
            else per_path[path][name],
            "launches_from": path, "launches_by_path": on_paths(name),
            "max_abs_err": diff.max_abs[name],
            "ms": t_srv["ms"], "plain_ms": t_srv["plain_ms"],
            "bound_ms": t_srv["bound_ms"], "bound_by": "bytes",
            "library_ms": t_srv["library_ms"], "ms_events": t_srv["ms_events"],
            "ms_call": t_srv["ms_call"], "ms_stage": t_srv["ms_stage"],
            "ms_stage_parts": t_srv["ms_stage_parts"],
            "kernels_a_call": t_srv["kernels_a_call"], "ms_units": t_srv["ms_units"],
            "parity_kernels_a_call": life[name]["parity_kernels"]
            / max(1, life[name]["parity_launches"]),
            "shape": {"G": t_srv["G"], "W": t_srv["W"], "N": t_srv["N"]},
            "comparisons": diff.checked[name],
            **{p: {k: life[name][p][k] for k in
                   ("G", "W", "N", "ms", "ms_events", "kernels_a_call", "ms_units",
                    "ms_call", "ms_stage", "ms_stage_parts", "plain_ms", "library_ms",
                    "bound_ms")}
               for p in ("server_n1", "headline", "rc", "recovery", "ledger", "scenario")},
            "checked_shapes": {k: LIFE_SHAPES[k][:2] for k in LIFE_SHAPES},
            **({"density_wake_us_per_name": {
                "per_name": dens["ablation"]["per_name_us"],
                "batched": dens["ablation"]["batched_us_per_name"]},
                "density_kernels_a_call": dens["kernel_launches_total"][name]
                / max(1, dens["launches_total"][name])}
               if name in LIFE_ONE_PASS and path == "density" else {}),
        })
    t_pack = pack["ar4"]
    kernels.append({
        "name": "gp_pack_rows", "route": "cuda",
        "source": "gigapaxos_tpu_torch/csrc/gp_pack_rows.cu",
        "replaces": "gigapaxos_tpu/manager.py:88",
        "launches": rcs["launches"]["gp_pack_rows"], "launches_from": "rc_stepped",
        "launches_by_path": on_paths("gp_pack_rows"),
        "max_abs_err": diff.max_abs["gp_pack_rows"],
        "ms": t_pack["ms"], "plain_ms": t_pack["plain_ms"],
        "bound_ms": t_pack["bound_ms"], "bound_by": "bytes",
        "library_ms": t_pack["library_ms"], "ms_events": t_pack["ms_events"],
        "ms_call": t_pack["ms_call"], "ms_stage": t_pack["ms_stage"],
        "shape": {k: t_pack[k] for k in ("G", "W", "R")},
        "comparisons": diff.checked["gp_pack_rows"],
        **{p: pack[p] for p in ("ar3", "rc", "rc4", "ledger")},
        "checked_shapes": dict(PACK_SHAPES),
    })
    return kernels


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's chip smoke (one card)")
    ap.add_argument("--phases", help="comma-separated subset of phases to run "
                    "(no kernels or device line is printed); default: all")
    ap.add_argument("--host-ms", metavar="ROOT",
                    help="only time the host side of create, jump, restore_paused "
                    "and restore_rows at N=1 (host_side_ms) on the port's tree at "
                    "ROOT and print it as one JSON line")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if args.host_ms:
        root = os.path.abspath(args.host_ms)
        if not os.path.isdir(os.path.join(root, "gigapaxos_tpu_torch")):
            fail(f"--host-ms: no gigapaxos_tpu_torch/ under {root}")
        sys.path.insert(0, root)
        log(json.dumps({"root": root, **host_side_ms(torch.device("cuda", 0))}))
        return 0
    if not os.path.isdir(os.path.join(HERE, "gigapaxos_tpu_torch", "csrc")):
        fail("run from a checkout: gigapaxos_tpu_torch/ is missing")
    sys.path.insert(0, HERE)
    # the serving workers phase 10 spawns import the package from here too
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    # a hang anywhere dumps every thread's stack and exits nonzero before
    # the run's time limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    from gigapaxos_tpu_torch.ops import gp_kernels

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else f"{kind}, power limit not read"
    bw = peak_bandwidth(kind)
    log(f"device: {kind}; {smi_line}; peak memory rate {bw:.3g} B/s; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    libs = gp_kernels.build(force=True)
    gp_kernels.lib()
    log(f"build: {', '.join(os.path.basename(p) for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for src, text in gp_kernels.BUILD_INFO.get("ptxas", {}).items():
        for k in ptxas_summary(text):
            log(f"  ptxas {src}: {k['kernel']}: {k['registers']} registers, "
                f"{k['stack']} B stack frame, "
                f"{k['spill_stores']} B spill stores, {k['spill_loads']} B spill "
                f"loads, {k['smem']} B static shared memory")

    diff = Diff()
    # the bench results phases 3, 14 and 15 write, for the baseline phase
    results = tempfile.mkdtemp(prefix="gp_smoke_results_")
    t_start = time.perf_counter()
    stamp = lambda name: log(
        f"[{time.perf_counter() - t_start:.1f} s] phase {name}"
    )
    # parity and timings first: they do not count launches; then every
    # main path, each with the counts set to 0 just before it
    phases = [
        ("parity", lambda: phase_parity(diff, device)),
        ("lifecycle", lambda: phase_lifecycle(diff, device, bw)),
        ("pack_rows", lambda: phase_pack_rows(diff, device, bw)),
        ("headline", lambda: phase_headline(diff, device, bw, results)),
        ("residency", lambda: phase_residency(diff, device, bw)),
        ("step_shapes", lambda: phase_step_shapes(diff, device, bw)),
        ("density", lambda: phase_density(device)),
        ("state_transfer", lambda: phase_state_transfer(device)),
        ("server", lambda: phase_server(device)),
        ("rc_stepped", lambda: phase_rc_stepped(device)),
        ("reconfiguration", lambda: phase_reconfiguration(device)),
        ("sharded", lambda: phase_sharded(device, out.get("server"))),
        # the control: the same deployment with each worker at the server
        # shape's rows, so that ticks/s per process can be held against
        # phase 6's at equal rows per engine
        ("sharded_rows", lambda: phase_sharded(
            device, out.get("server"), rows=SHARDED_WORKERS * SERVER["G"],
            label="sharded_rows")),
        ("txn", lambda: phase_txn(device)),
        ("ledger", lambda: phase_ledger(device)),
        ("chaos", lambda: phase_chaos(device)),
        ("recovery", lambda: phase_recovery(device)),
        ("heal", lambda: phase_heal(device)),
        ("mesh", lambda: phase_mesh(diff, device, bw, results)),
        ("ops", lambda: phase_ops(device, t_start, results)),
        ("baseline", lambda: phase_baseline(device, results)),
    ]
    only = [p for p in (args.phases or "").split(",") if p]
    unknown = set(only) - {name for name, _ in phases}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")
    out = {}
    for name, run in phases:
        if only and name not in only:
            continue
        stamp(name)
        out[name] = run()
    shutil.rmtree(results, ignore_errors=True)
    stamp("report")
    if only:
        # a partial run (for iterating on some phases) reports nothing
        log(f"partial run of {only} done; no kernels or device line")
        return 0

    # report
    kernels = kernels_line(diff, out["headline"], out["step_shapes"], out["lifecycle"],
                           out["density"], out["state_transfer"], out["server"],
                           out["pack_rows"], out["rc_stepped"], out["reconfiguration"],
                           out["sharded"], out["txn"], out["ledger"], out["chaos"],
                           out["recovery"], out["heal"], out["mesh"], out["ops"],
                           out["residency"])
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']}: no launch on the "
                 f"{k.get('launches_from', 'server')} path")
    head, srv, dens, xfer = out["headline"], out["server"], out["density"], out["state_transfer"]
    rcs, rcn, pack = out["rc_stepped"], out["reconfiguration"], out["pack_rows"]["ar4"]
    ab, ch = dens["ablation"], dens["churn"]
    shd, txn, chs = out["sharded"], out["txn"], out["chaos"]
    ctl, rec = out["sharded_rows"], out["recovery"]
    rst = rec["restart"]
    chaos_s = ", ".join(f"{k} {v['seconds']:.4g} s" for k, v in chs.items()
                        if k != "launches")
    log(f"summary: sharded {shd['req_per_s']:.6g} req/s p50 {shd['p50_ms']:.6g} ms "
        f"p99 {shd['p99_ms']:.6g} ms over {SERVER['R']} actives x {SHARDED_WORKERS} "
        f"workers; ticks/s per process over the request window: phase 6 "
        f"{[round(t, 4) for t in srv['ticks_per_s']]} (3 servers in one process, "
        f"{SERVER['G']} rows each), workers at {shd['worker_shape'][0]} rows "
        f"{[[round(t, 4) for t in per] for per in shd['ticks_per_s']]}, at "
        f"{ctl['worker_shape'][0]} rows "
        f"{[[round(t, 4) for t in per] for per in ctl['ticks_per_s']]}; "
        f"txn {txn['transfers']['txns']} transactions "
        f"({txn['transfers']['committed']} committed) in "
        f"{txn['transfers']['seconds']:.6g} s, soak {txn['soak']['manager_ticks']} "
        f"manager ticks; chaos {chaos_s}")
    led = out["ledger"]["doc"]
    log(f"summary: ledger {LEDGER['accounts']} accounts on {LEDGER_ENGINE['G']} rows, "
        f"{LEDGER['txns']} transactions ({led['committed']} committed), audit "
        f"{led['audit']}: boot {led['boot_s']:.6g} s, {led['steps']} steps at "
        f"{led['ms_per_step']:.6g} ms a cluster step, {led['txns_per_s']} txn/s, "
        f"commit p50 {led['commit_latency_s']['p50']:.6g} s p99 "
        f"{led['commit_latency_s']['p99']:.6g} s; baseline fresh check "
        f"{out['baseline']['fresh_check']['value']} >= "
        f"{out['baseline']['fresh_check']['band_lower']} in band; on {smi_line}")
    log(f"summary: host stages of a tick, ms per tick over the request windows: "
        f"a phase 6 server at {SERVER['G']} rows {srv['tick_stages_ms']}; AR0's "
        f"first worker at {shd['worker_shape'][0]} rows {shd['tick_stages_ms']}, at "
        f"{ctl['worker_shape'][0]} rows {ctl['tick_stages_ms']}")
    log(f"summary: headline steady {head['arms']['steady']['dec_per_s']:.6g} "
        f"dec/s, failover {head['arms']['failover']['dec_per_s']:.6g} dec/s; "
        f"server {srv['req_per_s']:.6g} req/s p50 {srv['p50_ms']:.6g} ms "
        f"p99 {srv['p99_ms']:.6g} ms; density {dens['names']} names: boot "
        f"{dens['boot']['names_per_s']:.6g} names/s, wake {ab['per_name_us']:.6g} "
        f"us/name per-name vs {ab['batched_us_per_name']:.6g} batched, churn "
        f"{ch['req_per_s']:.6g} req/s; state transfer jumped "
        f"{xfer['gap_slots']} slots; reconfiguration {rcn['creates_per_s']:.6g} "
        f"creates/s, {rcn['req_per_s']:.6g} req/s, migrate p50 "
        f"{rcn['move_p50_ms']:.6g} ms; rc_stepped {rcs['steps_script']} + "
        f"{rcs['steps_lossy']} steps; gp_pack_rows {pack['ms']:.6g} ms vs bound "
        f"{pack['bound_ms']:.6g} ms; on {smi_line}")
    log(f"summary: recovery {rec['names']} names, {rec['journal_files']} journal "
        f"files, {rec['dir_bytes']} B: restart to serving "
        f"{rst['restart_to_serving_s']:.6g} s, first serve "
        f"{rst['time_to_first_serve_s']:.6g} s, full hydration "
        f"{rst['full_hydrate_s']:.6g} s, eager baseline "
        f"{rec['eager_baseline_restart_s']:.6g} s, replay {rst['replay_s']:.6g} s, "
        f"create {rec['build']['create_s']:.6g} s, checkpoint "
        f"{rec['build']['checkpoint_s']:.6g} s; on {smi_line}")
    cap, abl, ops = head["capacity"], head["ablation"]["result"], out["ops"]
    inproc = {k: ops[k]["capacity_rps"] for k in ("in_process", "in_process_unreplicated")
              if k in ops}
    hops = {k: round(v["mean_ms"], 3) for k, v in ops["trace"]["hops"].items()}
    log(f"summary: bench capacity G={CAPACITY['G']}: {cap['record']}; ablation "
        f"G={ABLATION['G']}: N=1 {abl['arms']['n1']['decided_per_s']} decided/s over "
        f"{abl['arms']['n1']['host_dispatches']} dispatches, N=8 "
        f"{abl['arms']['n8']['decided_per_s']} over {abl['arms']['n8']['host_dispatches']}, "
        f"bit-exact {abl['parity']['bit_exact']}; ops: probe --attach at {OPS_ROWS} "
        f"rows {ops['attach']['capacity_rps']} req/s, probe at its defaults "
        f"{ops['probe']['capacity_rps']} req/s, in-process {inproc or 'left out'}; "
        f"trace hops, mean ms {hops}; on {smi_line}")
    log(residency_summary(out["residency"], chs, smi_line))
    mesh = out["mesh"]
    log(f"summary: mesh faces at G={MESH['G']} on one card (logical devices; no "
        f"multi-card speed): dec/s "
        + ", ".join(f"{k} {v['dec_per_s']:.6g}" for k, v in mesh["rates"].items())
        + f"; exchange {mesh['exchange_ms']:.6g} ms per step vs bound "
        f"{mesh['exchange_bound_ms']:.6g} ms ({mesh['exchange_bytes']} B); peak "
        f"{mesh['peak_bytes']} B; phase {mesh['seconds']:.1f} s; on {smi_line}")
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
