"""Core engine flags — the PaxosConfig analog.

Re-creation of the reference's ``PaxosConfig.PC`` flag enum
(``src/edu/umass/cs/gigapaxos/PaxosConfig.java:214-967``), keeping the
reference's names and defaults where the concept survives, plus new
Engine knobs (group capacity padding, slot-window size, mesh shape).
Register with :class:`gigapaxos_tpu_torch.utils.Config` and read via
``Config.get(PC.FLAG)``.
"""

from __future__ import annotations

from .utils.config import Config, FlagEnum


class PC(FlagEnum):
    # ---- scale envelope (ref: PaxosConfig.java:263,532,537,403) -------
    PINSTANCES_CAPACITY = 2 ** 21        # max in-memory paxos groups (2M ref parity)
    MAX_GROUP_SIZE = 16                  # max replicas per group
    MAX_OUTSTANDING_REQUESTS = 8000
    MAX_BATCH_SIZE = 2000                # client requests coalesced per proposal batch

    # ---- engine shape (new; no reference counterpart) -------------
    # allocated dense engine rows for a deployed node (device-memory cost is
    # O(ENGINE_ROWS * SLOT_WINDOW)); PINSTANCES_CAPACITY above is the
    # design CEILING (2M ref parity) — raise ENGINE_ROWS toward it on the device
    # (GROUP_BLOCK and ENGINE_DTYPE were dropped: the engine is int32 by
    # design and row capacity needs no padding quantum — a flag that
    # promises an unimplemented capability is worse than none)
    ENGINE_ROWS = 65536
    SLOT_WINDOW = 16                     # W: in-flight slots per group (ring buffer)
    # the torch device a CLI node's engine runs on ("" = the CUDA card,
    # which must be present; "cpu" = the plain PyTorch engine)
    DEVICE = ""

    # ---- batching (ref: RequestBatcher / PaxosPacketBatcher) ----------
    BATCHING_ENABLED = True
    BATCH_SLEEP_MS = 0.2                 # adaptive batcher base sleep
    MIN_PP_BATCH_SIZE = 3

    # ---- serving pipeline (host-path ceiling: dispatch/codec/sharding) -
    # double-buffered dispatch: the jitted engine step for batch N runs
    # asynchronously (dispatch-and-go) while transport threads frame,
    # decode, and admit batch N+1 — the manager lock is NOT held across
    # the device sync, so ingress/codec work overlaps the step
    # instead of following it.  False = serial tick (lock held across the
    # whole step), the pre-pipeline behavior; the two are step-for-step
    # state-identical (tests/test_pipeline.py pins it)
    PIPELINE_DISPATCH = True
    # binary client hot-path frames ('R' request / 'S' response batches,
    # net/hot_codec.py): replaces per-request JSON on the client plane;
    # decode/encode run in the native layer when available (GP_NO_NATIVE
    # or a missing toolchain falls back to a byte-identical pure-Python
    # codec).  False = JSON client frames everywhere (legacy)
    BINARY_CLIENT_FRAMES = True
    # worker sharding: >1 splits this node's groups across that many
    # worker PROCESSES by name hash (group-range shards, the checkpoint-
    # shard scheme applied to serving) — each worker owns its own engine
    # arrays and journal and exchanges compact blobs with the SAME worker
    # index on peer replicas; the parent process only accepts and routes.
    # 1 (default) = today's single-process node, exactly
    SERVING_WORKERS = 1
    # worker w of a node listens at node_port + this + w (mesh), with the
    # usual CLIENT_PORT_OFFSET split layered on top inside the worker
    SERVING_WORKER_PORT_OFFSET = 500
    # multi-step device residency: consensus rounds the unified step
    # (parallel/spmd.py:make_step) runs per host dispatch, over
    # device-resident request/response rings.  1 (default) = one step per
    # dispatch, the exact legacy program; N > 1 amortizes the Python
    # dispatch + sync + post-step host cycle over N engine steps (higher
    # throughput under sustained load, +N-1 steps of decide latency for
    # a request arriving mid-dispatch).  The request ring holds
    # K * N staged vids per group per dispatch
    ENGINE_STEPS_PER_DISPATCH = 1

    # ---- durability (ref: PaxosConfig.java:240,314,334,410) -----------
    ENABLE_JOURNALING = True
    SYNC_JOURNAL = False                 # fsync every journal batch
    MAX_LOG_FILE_SIZE = 64 * 1024 * 1024
    MAX_LOG_MESSAGE_SIZE = 5 * 1024 * 1024
    CHECKPOINT_INTERVAL = 400            # slots between app checkpoints
    JOURNAL_GC_FREQUENCY = 1             # GC every Nth checkpoint
    PAXOS_LOGS_DIR = "paxos_logs"

    # ---- liveness (ref: PaxosConfig.java:668; FailureDetection.java:62-79)
    FAILURE_DETECTION_TIMEOUT_S = 6.0
    PING_PERIOD_S = 3.0                  # = timeout / 2
    COORDINATOR_LONG_DEAD_FACTOR = 3.0   # long-dead at 3x timeout
    SYNC_THRESHOLD = 32                  # missing decisions before sync kicks in
    MAX_SYNC_DECISIONS_GAP = 1 << 14
    # payload-retention/jump horizon in units of the slot window: a member
    # more than this many windows behind the majority frontier is written
    # off for payload retention and recovers via checkpoint transfer
    # (MAX_SYNC_DECISIONS_GAP plays this role in the reference)
    JUMP_HORIZON_WINDOWS = 4
    TICK_INTERVAL_S = 0.01               # server drive-loop cadence
    RESPONSE_CACHE_TTL_S = 60.0          # exactly-once retransmit cache TTL

    # ---- observability (obs/: gplog + reqtrace + metrics + flight) ----
    # cadence of the server's INFO stats line (engine counters +
    # DelayProfiler); the line only renders when gp.server is at INFO
    # (GP_LOG=server:INFO), so the default deployment pays a level check
    STATS_LOG_PERIOD_S = 10.0
    # black-box flight recorder (obs/flight.py; always on): ring sizes
    # for the per-step engine summaries and the last-K decided
    # (group, slot, ballot, vid) entries, and where dumps land on a
    # SoakDivergence / tick-loop exception / `flightdump` admin op.
    # (Per-request trace SAMPLING is the GP_TRACE_SAMPLE env var, not a
    # flag: the decision is made in clients, possibly outside any
    # properties file.)
    FLIGHT_STEPS = 512
    FLIGHT_DECIDED = 1024
    FLIGHT_DIR = "flight_dumps"
    # per-directory dump cap: after each dump the oldest files beyond
    # this count are rotated out, so repeated local soak runs stop
    # accumulating unbounded JSON in the repo root (0 disables rotation)
    FLIGHT_MAX_DUMPS = 64
    # device-plane observatory (obs/device.py): where the `profile`
    # admin op drops torch.profiler captures, how many capture dirs are
    # kept (flight-recorder-style rotation), and the per-capture wall
    # cap (the op runs synchronously on a transport thread)
    ENGINE_PROFILE_DIR = "engine_profiles"
    ENGINE_PROFILE_MAX_DUMPS = 8
    ENGINE_PROFILE_MAX_S = 5.0
    # group-heat telemetry: rows listed in the `stats` op's
    # engine.heat.top_groups block (the on-device [G] accumulator is
    # always on; this only sizes the human-readable table)
    GROUP_HEAT_TOPK = 8
    # per-phase latency budgets for `scripts/gp_trace.py --slo`
    # (phase=milliseconds, comma-separated; phases are the merged-trace
    # labels of obs/tracemerge.py plus the pseudo-phase `total`).
    # Soak triage: a merged trace whose phase total exceeds its budget
    # flags the trace and the script exits non-zero.
    SLO_BUDGETS_MS = (
        "ingress=50,consensus=500,execute-gate=250,flush=100,"
        "client-wire=250,total=2000"
    )

    # ---- transactions (txn/: sorted 2PC-over-Paxos) --------------------
    # driver budget from begin to all-prepared, and the resolver's
    # presumed-abort horizon for undecided coordinator records — LOGICAL
    # seconds (the soak clock is step-driven and compressed)
    TXN_PREPARE_TIMEOUT_S = 5.0
    # resolver cadence: how often the in-doubt resolver scans the
    # coordinator group for records to re-drive or presume-abort
    TXN_RESOLVE_PERIOD_S = 1.0
    # concurrent transactions a driver pool keeps in flight (soak and
    # bank-ledger workload concurrency bound)
    TXN_MAX_INFLIGHT = 32

    # ---- recovery plane (new; restart-to-serving SLO) ------------------
    # checkpoint sharding: >1 splits every snapshot into this many
    # group-range shards under a content-hashed manifest (torn shard
    # writes are detected and recovery falls back to the previous
    # generation's anchor); 1 keeps the legacy single npz+sidecar pair
    RECOVERY_CHECKPOINT_SHARDS = 4
    # segmented replay: journal files after the checkpoint anchor are
    # scanned/CRC-verified/decoded on this many worker threads (the
    # native gp_journal CRC releases the GIL; GP_NO_NATIVE falls back to
    # zlib); blocks still APPLY in journal order.  <=1 = sequential
    RECOVERY_REPLAY_WORKERS = 4
    # lazy hydration: serve hot names (recency-ordered from the manifest
    # hints) as soon as the engine arrays + replay land; restore the cold
    # tail's app states in a background worker.  False = full synchronous
    # restore before serving (the pre-recovery-plane behavior)
    RECOVERY_LAZY_HYDRATION = True
    # names hydrated synchronously before the node starts serving (the
    # bounded restart-to-serving window); everything else is background
    RECOVERY_HOT_NAMES = 1024
    # cold names restored per background batch between lock releases
    RECOVERY_HYDRATION_BATCH = 256

    # ---- pause / residency (ref: PaxosConfig.java:277,291) ------------
    PAUSE_OPTION = True
    DEACTIVATION_PERIOD_S = 60.0
    PAUSE_BATCH_SIZE = 1000
    # a just-resumed name is exempt from eviction for this long
    # (hysteresis against pause/resume flap under a rotating hot set)
    PAUSE_EVICTION_HYSTERESIS_S = 30.0
    # paused-table spill backend: packed segment files (utils/
    # packedstore.py — bounded inodes, sequential wake reads) vs the
    # file-per-key DiskMap fallback
    PACKED_SPILL = True
    SPILL_SEGMENT_BYTES = 4 * 1024 * 1024
    SPILL_COMPACT_RATIO = 0.5
    SPILL_SUBDIRS = 64

    # ---- request handling ---------------------------------------------
    REQUEST_TIMEOUT_S = 8.0              # client callback GC (ref: PaxosClientAsync 8s)
    RESPONSE_CACHE_SIZE = 1 << 16        # exactly-once retransmit cache

    # ---- test / emulation modes (ref: PaxosConfig.java:435,453) -------
    EMULATE_UNREPLICATED = False
    LAZY_PROPAGATION = False

    # ---- transport ------------------------------------------------------
    # (CHARSET was dropped: the wire is JSON/UTF-8 + packed int32 tensors
    # by design — a charset knob could only corrupt it)
    CLIENT_PORT_OFFSET = 100             # ref: ReconfigurationConfig port offsets
    HTTP_PORT_OFFSET = 300

    # ---- TLS (ref: SSL modes CLEAR/SERVER_AUTH/MUTUAL_AUTH,
    # SSLDataProcessingWorker.java:59, PaxosConfig.java:548-553; key
    # material as PEM paths instead of JKS keystores).  Setting
    # CLIENT_SSL_MODE opens a SEPARATE client-facing listener at
    # port + CLIENT_PORT_OFFSET running that mode (the reference's
    # per-plane port split: e.g. a MUTUAL_AUTH server mesh with
    # SERVER_AUTH clients).
    SSL_MODE = "CLEAR"                   # CLEAR | SERVER_AUTH | MUTUAL_AUTH
    CLIENT_SSL_MODE = ""                 # "" = clients share the mesh port
    SSL_KEY_FILE = ""                    # this node's private key (PEM)
    SSL_CERT_FILE = ""                   # this node's certificate (PEM)
    SSL_CA_FILE = ""                     # trust anchors (PEM bundle)


Config.register(PC)
