"""PaxosManager — per-node host orchestration of the batched engine.

API-parity target: ``PaxosManager`` (``PaxosManager.java:120`` —
createPaxosInstance / propose / proposeStop / kill, packet dispatch,
outstanding-request callbacks, response cache, recovery), re-architected
around the vectorized engine:

* All groups' consensus state lives on device ([G]/[G, W] arrays); the
  manager owns the *host* side: name → group-row allocation, the request
  payload arena, app execution, callbacks, durability, and the per-tick
  drive loop.
* Inter-replica consensus traffic is the engine blob (tensor exchange);
  the manager's host channel carries only what tensors can't: request
  payloads (vid → bytes), mirroring the reference's DIGEST_REQUESTS mode
  (``PaxosConfig.java:780``) where accepts carry digests and request
  bodies travel once.
* A replica that is not a group's coordinator forwards proposals to the
  believed coordinator (the unicast-PROPOSAL path,
  ``PaxosInstanceStateMachine.java:837-851``) via the host channel.

The tick cycle (one call to :meth:`tick`):
  1. drain per-group request queues into the [G, K] admission lanes;
  2. run the engine step (one gp_step kernel launch per substep on the
     card, the plain PyTorch engine on the CPU);
  3. journal the accept delta (log-before-send,
     ``AbstractPaxosLogger.logAndMessage`` rule) and new payloads;
  4. execute newly decided slots in order through the app (payload-gated:
     a slot whose payload hasn't arrived yet parks the group's cursor —
     the retry-forever analog of ``PaxosInstanceStateMachine.execute``);
  5. fire entry-replica callbacks / response cache;
  6. return the fresh blob + host-channel payload delta for publication.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .interfaces.app import Replicable
from .ops.ballot import NULL, ballot_coord, ballot_num, encode_ballot
from .packets.paxos_packets import (
    RequestPacket,
    StatePacket,
    SyncDecisionsPacket,
)
from .paxos_config import PC
from .utils.config import Config
from .ops.engine import (
    STOP_BIT,
    Blob,
    EngineConfig,
    EngineState,
    init_state,
    StepOutputs,
    make_blob,
    make_blob_vec,
    pack_rows,
    resolve_device,
    split_blob_vec,
    split_out_vec,
    to_host,
)
from .parallel.spmd import make_step
from .obs import gplog
from .obs.flight import FlightRecorder
from .obs.metrics import MetricsRegistry
from .obs.reqtrace import RequestTracer
from .ops.lifecycle import create_groups, kill_groups, restore_paused_rows
from .storage.logger import PaxosLogger
from .utils.profiler import DelayProfiler

# Every tick flavor steps through the ONE unified factory
# (parallel/spmd.py:make_step, io="packed_host").  The dispatch path
# donates the state: the manager owns it exclusively (every external view
# is an identity check or a host-side numpy copy), so the step may reuse
# its buffers (today it writes each state to new tensors and updates only
# the heat accumulator in place).  The Blob-exchange tick
# (_tick_locked, the test-cluster harness) uses a donate=False instance:
# that harness caches blob views aliasing the live state across ticks.


def _dev(x, dtype, device) -> torch.Tensor:
    """A host array (or tensor) -> a tensor on the manager's device.  A
    list of equal-shape host rows (the server's gathered blob vectors)
    is uploaded row by row into one tensor: stacking them on the host
    first would copy every row once more into a fresh allocation."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    if isinstance(x, (list, tuple)):
        # torch takes writable arrays only: a row decoded from a small
        # frame (bytes) is copied here; a large frame arrives writable
        rows = [np.require(r, requirements="W") for r in x]
        out = torch.empty((len(rows),) + rows[0].shape, dtype=dtype,
                          device=device)
        for dst, row in zip(out, rows):
            dst.copy_(torch.from_numpy(row))
        return out
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _mix32(h: int, vid: int) -> int:
    """Host mirror of the engine's app-hash fold (int32 wraparound)."""
    with np.errstate(over="ignore"):
        h32 = np.int32(h)
        v32 = np.int32(vid)
        return int((h32 * np.int32(31) + v32) ^ (v32 << np.int32(7)))

def _instance_tag(name: str, epoch: int) -> int:
    """Deterministic nonzero int32 identity of (name, epoch) — the blob's
    cross-instance guard (engine ``tag`` lane).  Every replica computes it
    from the same create parameters, so tags agree without coordination;
    0 is reserved for inert rows."""
    import zlib

    t = zlib.crc32(f"{name}:{int(epoch)}".encode("utf-8")) & 0x7FFFFFFF
    return t or 1


# vid layout: [node_id : 5][counter : 24] under STOP_BIT (bit 30) and
# BATCH_BIT (bit 29) — the counter wraps per node at ~16M in-flight
# request payloads, far above the outstanding cap; node ids follow
# ballot.COORD_BITS (ids 0..31).  A BATCH vid's arena payload is not an
# app request but an encoded ORDERED LIST of client requests decided as
# one consensus value (the true RequestBatcher semantics: up to
# MAX_BATCH_SIZE requests per proposal, RequestPacket.java:189-246 nested
# `batched` array + PaxosManager.proposeBatched:1226); execution unpacks
# and runs each sub-request through the app with per-request dedup and
# callbacks.  STOP_BIT and BATCH_BIT never combine: an epoch-final stop
# is epoch-scoped and rides alone.
VID_NODE_SHIFT = 24
VID_COUNTER_MASK = (1 << VID_NODE_SHIFT) - 1
BATCH_BIT = 1 << 29


def encode_batch(subs: List[Tuple[int, int, str]]) -> str:
    """Encode [(request_id, entry_replica, value), ...] as one arena
    payload.  JSON keeps Python ints exact (client ids reach 2^62)."""
    return json.dumps(subs, separators=(",", ":"))


def decode_batch(payload: str) -> List[Tuple[int, int, str]]:
    return [(int(r), int(e), v) for r, e, v in json.loads(payload)]


class SlimRequest(RequestPacket):
    """Hot-path request object for decided-slot execution.

    Constructing the full ``RequestPacket`` dataclass (field machinery +
    ``__post_init__`` batched/address coercions) was the single biggest
    executor cost at batch scale — ~3 constructions per client request
    across a 3-replica group.  This subclass keeps ``isinstance(...,
    RequestPacket)`` contracts (the RC record app asserts it) but assigns
    only the consumed fields."""

    def __init__(self, paxos_id: str, request_id: int, request_value: str,
                 stop: bool = False):
        self.paxos_id = paxos_id
        self.version = -1
        self.request_id = request_id
        self.request_value = request_value
        self.stop = stop
        self.entry_replica = -1
        self.client_address = None
        self.response_value = None
        self.batched = []
        self.entry_time = 0.0


def execute_uncoordinated(app, names, name: str, value: str, request_id,
                          callback, gate=None) -> Optional[bool]:
    """Uncoordinated local execution (linearizable-writes / local-reads
    apps, ref ``LinWritesLocReadsApp.java:26-44``): when the app declares
    a request uncoordinated via ``is_coordinated``, answer it from THIS
    replica's state without entering consensus — no vid, no inflight
    slot, no dedup entry (a re-sent read just re-reads).  The ONE routing
    block shared by the coordinator and the server ingress paths.

    Returns ``True`` if executed locally, ``False`` if the request IS
    uncoordinated but ``name`` isn't hosted here, ``None`` if the app
    doesn't route or the request is coordinated (caller proposes
    normally)."""
    is_coord = getattr(app, "is_coordinated", None)
    if is_coord is None or is_coord(value):
        return None
    if names.get(name) is None:
        return False
    if gate is not None and not gate(name):
        # un-hydrated name (recovery plane): reading its app state now
        # would serve the pre-restore blank — fall through to the
        # coordinated path, which queues until hydration lands
        return None
    req = SlimRequest(name, int(request_id or 0), value)
    app.execute(req, do_not_reply_to_client=False)
    if callback is not None:
        callback(request_id, getattr(req, "response_value", None))
    return True


class Outstanding:
    """Entry-replica callback table with TTL GC (GCConcurrentHashMap analog,
    ``PaxosManager.java:192-207``)."""

    def __init__(self, timeout_s: Optional[float] = None):
        if timeout_s is None:
            timeout_s = Config.get_float(PC.REQUEST_TIMEOUT_S)
        self.timeout_s = timeout_s
        self._map: Dict[int, Tuple[float, Callable]] = {}

    def put(self, request_id: int, cb: Callable) -> None:
        self._map[request_id] = (time.time(), cb)

    def put_at(self, request_id: int, cb: Callable, t: float) -> None:
        """put() with a caller-shared timestamp (batched ingress)."""
        self._map[request_id] = (t, cb)

    def pop(self, request_id: int) -> Optional[Callable]:
        ent = self._map.pop(request_id, None)
        return ent[1] if ent else None

    def gc(self) -> int:
        cut = time.time() - self.timeout_s
        dead = [k for k, (t, _) in self._map.items() if t < cut]
        for k in dead:
            del self._map[k]
        return len(dead)

    def __len__(self) -> int:
        return len(self._map)


class PaxosManager:
    def __init__(
        self,
        my_id: int,
        app: Replicable,
        cfg: EngineConfig,
        log_dir: Optional[str] = None,
        sync_journal: Optional[bool] = None,
        checkpoint_every: Optional[int] = None,  # CHECKPOINT_INTERVAL analog
        jump_horizon: Optional[int] = None,      # slots; None -> flag * W
        device=None,
    ):
        self.my_id = int(my_id)
        self.app = app
        self.cfg = cfg
        # the engine's device: the card unless the caller asks for the
        # CPU (device="cpu"); with no card and no explicit device, raise
        self.device = resolve_device(device)
        G, W, K = cfg.n_groups, cfg.window, cfg.req_lanes
        # observability plane: structured log, bounded per-request trace
        # ring (DEBUG-gated; GP_TRACE=1 / GP_LOG=trace:DEBUG), and the
        # per-step engine metrics registry (always on — per-STEP numpy
        # reductions, never per-request work)
        self.log = gplog.node_logger("manager", my_id)
        self.tracer = RequestTracer(my_id)
        self.metrics = MetricsRegistry(node=my_id)
        # black-box flight recorder (obs/flight.py): always-on bounded
        # rings of per-step engine summaries + last-K decided
        # (group, slot, ballot, vid), dumped on divergence/exception/
        # `flightdump` — O(1) per tick, fed from _post_step_locked
        self.flight = FlightRecorder(my_id)
        # cross-node trace contexts: request_id -> (trace_id, origin,
        # hop) for requests sampled at their origin (GP_TRACE_SAMPLE).
        # Installed at propose time (client frame / forward) or from
        # payload gossip, read on the decide/execute/flush paths so
        # every hop's reqtrace events share the trace id.  Bounded FIFO;
        # mutations run under the state lock, the flush path's read is
        # a benign racy dict lookup (diagnostics only).
        self.trace_ctx: "Dict[int, Tuple[int, int, int]]" = {}
        self.TRACE_CTX_CAP = 8192
        # contexts installed HERE since the last tick, to gossip to
        # peers on the payloads frame (drained by _post_step_locked) —
        # peers need the context to stamp their decide/execute events
        self._tc_gossip: Dict[int, Tuple[int, int, int]] = {}
        # host cache of each row's last-known coordinator id (from the
        # promised ballot) — flip counting reads `bal` only on the rare
        # ticks where a ballot actually rose (bal_new nonzero)
        self._coord_cache = np.full(G, -1, np.int32)
        # host view of each row's promised ballot, under the same
        # discipline: seeded at create (the initial ballot is computed
        # host-side), refreshed from the one rise-tick `bal` pull.  The
        # decide events' (group, slot, ballot) attribution and the
        # flight recorder's decided ring read THIS, never the device —
        # a per-commit-tick `bal` pull costs a device sync per tick
        self._bal_host = np.full(G, NULL, np.int32)

        # explicit ctor args win; otherwise the three-tier flag system
        # decides (defaults < properties file < env/CLI — PaxosConfig.PC)
        if sync_journal is None:
            sync_journal = Config.get_bool(PC.SYNC_JOURNAL)
        if not Config.get_bool(PC.ENABLE_JOURNALING):
            log_dir = None
        self.logger: Optional[PaxosLogger] = (
            PaxosLogger(
                my_id, log_dir, sync=sync_journal,
                max_file_size=Config.get_int(PC.MAX_LOG_FILE_SIZE),
            ) if log_dir else None
        )
        self.checkpoint_every = (
            Config.get_int(PC.CHECKPOINT_INTERVAL)
            if checkpoint_every is None else checkpoint_every
        )
        # members lagging more than this many slots behind the majority
        # are written off for payload retention and recover via checkpoint
        # transfer; MAX_SYNC_DECISIONS_GAP caps the horizon outright (a
        # member further behind than the cap always jumps, never syncs —
        # PaxosInstanceStateMachine.java:130)
        self.jump_horizon = (
            min(
                Config.get_int(PC.JUMP_HORIZON_WINDOWS) * cfg.window,
                Config.get_int(PC.MAX_SYNC_DECISIONS_GAP),
            )
            if jump_horizon is None else int(jump_horizon)
        )
        # missing-decision count past which a straggler's pull flags
        # "missing too much" and peers prefer serving a checkpoint over
        # individual payloads (SYNC_THRESHOLD, :127)
        self.sync_threshold = max(
            cfg.window, Config.get_int(PC.SYNC_THRESHOLD)
        )
        # group-size ceiling (MAX_GROUP_SIZE, PaxosConfig.java:532); the
        # engine's member bitmask caps at 32 regardless
        self.max_group_size = min(32, Config.get_int(PC.MAX_GROUP_SIZE))
        # exactly-once dedup window: like the reference's TTL'd
        # GCConcurrentHashMap (PaxosManager.java:318-346), dedup is
        # guaranteed only within the cache's TTL+size window — a duplicate
        # re-proposal arriving after eviction can re-execute
        self.response_cache_ttl = Config.get_float(PC.RESPONSE_CACHE_TTL_S)
        self.response_cache_cap = Config.get_int(PC.RESPONSE_CACHE_SIZE)
        # admission back-pressure (MAX_OUTSTANDING_REQUESTS 8000 analog,
        # PaxosConfig.java:537): past this many in-flight requests the
        # entry path refuses with "overload" and clients back off
        self.max_outstanding = Config.get_int(PC.MAX_OUTSTANDING_REQUESTS)
        # request coalescing (RequestBatcher analog, RequestBatcher.java:40):
        # when a coordinated row's queue exceeds the lane count, consecutive
        # plain requests are packed into ONE consensus value (a BATCH vid)
        # of up to MAX_BATCH_SIZE sub-requests, so a hot group's throughput
        # is bounded by lanes*batch per tick, not lanes per tick
        self.batching_enabled = Config.get_bool(PC.BATCHING_ENABLED)
        self.max_batch_size = max(1, Config.get_int(PC.MAX_BATCH_SIZE))
        # minimum queued requests before coalescing bothers minting a batch
        # (MIN_PP_BATCH_SIZE gate analog, PaxosConfig.java:852)
        self.min_batch_trigger = max(2, Config.get_int(PC.MIN_PP_BATCH_SIZE))
        # multi-step device residency: N consensus rounds per host
        # dispatch over device-resident request/response rings — one
        # Python dispatch + sync + post-step cycle per N engine steps
        self.steps_per_dispatch = max(
            1, Config.get_int(PC.ENGINE_STEPS_PER_DISPATCH)
        )
        # the ONE unified step (parallel/spmd.py:make_step), packed-host
        # flavor; instances are memoized by (cfg, N, donate, heat,
        # device), so managers of the same shape share them.
        # heat=True threads the [G] device-resident activity accumulator
        # through every dispatch (decisions + admissions per group,
        # folded across substeps inside the device loop); the host pulls
        # it only at the stats cadence (pull_group_heat), never per tick
        # this node's own kernel launches (gp_step / gp_make_blob), bumped
        # by the wrappers beside their process-wide counts
        self.kernel_launches: Dict[str, int] = {}
        self._dispatch_step = make_step(
            cfg, None, self.steps_per_dispatch, donate=True,
            io="packed_host", heat=True, device=self.device,
        )
        self._tick_step = make_step(
            cfg, None, self.steps_per_dispatch, donate=False,
            io="packed_host", heat=True, device=self.device,
        )
        # retrace sentinel bookkeeping (obs/device.py): the sentinels are
        # SHARED across managers of the same shape, so per-node metrics
        # count deltas against the last totals this manager saw; the
        # sentinels are marked warm after this manager's first completed
        # dispatch — any compile after that is a retrace (hard invariant:
        # the hot dispatch never retraces after warmup)
        self._compile_seen = 0
        self._retrace_seen = 0
        # device-resident [G] group-activity accumulator + the host-side
        # cumulative view refreshed by pull_group_heat at stats cadence
        self._heat_dev = torch.zeros((G,), dtype=torch.int32,
                                     device=self.device)
        self._heat_host = np.zeros(G, np.int64)
        # vids staged into the device request ring by the LAST dispatch
        # (the device_queue_depth gauge)
        self._last_ring_depth = 0
        # test/emulation modes (PaxosManager.java:1731-1778): UNREPLICATED
        # answers at the entry replica without consensus (isolates app+wire
        # cost); LAZY_PROPAGATION additionally still drives consensus but
        # replies on local execution instead of commit
        self.emulate_unreplicated = Config.get_bool(PC.EMULATE_UNREPLICATED)
        self.lazy_propagation = Config.get_bool(PC.LAZY_PROPAGATION)
        # request ids currently executing via an emulation mode (guards
        # a retransmit racing the out-of-lock execution)
        self._emulating: set = set()

        # host-side tables
        self.names: Dict[str, int] = {}        # service name -> CURRENT epoch row
        self.row_name: Dict[int, str] = {}     # occupancy: row -> name (or name@vE)
        # rows created by a start-epoch whose COMPLETE hasn't been confirmed
        # yet: proposals are accepted and QUEUED but never admitted to
        # consensus (build_requests skips pending rows), so nothing can
        # commit on a row the reconfigurator's probe may still move — the
        # recreate in _create_locked is only safe because of this gate, and
        # the held queue follows the name to the new row
        self.pending_rows: set = set()
        # stopped prior epochs kept until the reconfigurator drops them
        # (epoch final state may still be fetched from their app snapshot)
        self.old_epochs: Dict[Tuple[str, int], int] = {}  # (name, epoch) -> row
        # fired on EVERY replica when an epoch-final stop request executes
        # (the reconfiguration layer captures the final state here);
        # signature: (name, row, epoch)
        self.on_stop_executed: Optional[Callable[[str, int, int], None]] = None
        # residency (pause/unpause, PaxosManager.java:2264-2392 analog):
        # paused groups' snapshots, keyed (name, epoch) — their rows are
        # freed for reuse; reactivation restores at a freshly probed row.
        # With a journal, the table itself pages to disk (DiskMap analog,
        # DiskMap.java:97): at 1M groups the paused snapshots must not all
        # be RAM-resident (durability is the journal's job regardless)
        if log_dir:
            import os as _os

            spill_dir = _os.path.join(log_dir, "paused_spill")
            cap = Config.get_int(PC.PAUSE_BATCH_SIZE) * 4
            if Config.get_bool(PC.PACKED_SPILL):
                from .utils.packedstore import PackedSpillStore

                self.paused = PackedSpillStore(
                    spill_dir, capacity=cap,
                    segment_bytes=Config.get_int(PC.SPILL_SEGMENT_BYTES),
                    compact_ratio=Config.get_float(PC.SPILL_COMPACT_RATIO),
                    subdirs=Config.get_int(PC.SPILL_SUBDIRS),
                )
            else:
                from .utils.diskmap import DiskMap

                self.paused = DiskMap(spill_dir, capacity=cap)
        else:
            self.paused = {}
        # name -> {epoch} mirror of self.paused's keys: restore() must
        # find a hibernated name's epochs without an O(paused) key scan
        # (the paused table holds the COLD tail — millions of names)
        self._paused_by_name: Dict[str, set] = {}
        # name -> wall time of last resume/create activity relevant to
        # eviction hysteresis (a just-woken name must not be re-paused
        # by the next sweep even if its traffic burst already ended)
        self._resumed_at: Dict[str, float] = {}
        self.row_activity = np.zeros(G, np.float64)  # wall time of last use
        # per-name arriving-request counts since the last demand report
        # (updateDemandStats analog; drained by the ActiveReplica layer)
        self.demand_counts: Dict[str, int] = {}
        self.demand_backlog = 0  # total unreported requests (flush trigger)
        self.arena: Dict[int, str] = {}        # vid -> request payload (json str)
        self.vid_meta: Dict[int, Tuple[int, int]] = {}  # vid -> (entry_replica, request_id)
        self.outstanding = Outstanding()
        # request_id -> (time, response).  Ids are unique in practice,
        # not by construction: node-minted ids ((nonce<<24)|counter, up
        # to ~2^61) OVERLAP the client range [2^53, 2^62) — collisions
        # are tolerated probabilistically, exactly like the reference's
        # random 63-bit ids (RequestPacket.java:83).
        # Consulted at propose (fast dedup) AND at execution (a client
        # retransmitting to a different entry replica creates a second
        # proposal for the same logical request; every replica sees the
        # same decided sequence, so skipping re-execution of a seen id is
        # deterministic across the group — at-least-once commit,
        # exactly-once execution; ref: PaxosManager.java:318-346).
        # request_id -> (time, response, name-of-execution).  The name
        # tag makes state-transfer dedup SOUND: a donor ships only
        # entries executed in the groups whose app state it serves — an
        # entry for any other group would suppress an execution the
        # receiver's state does not contain, while OMITTING an entry the
        # adopted state does contain lets a re-proposed duplicate
        # re-execute; both directions diverge the RSM (each was caught
        # by the chaos soak).  Names, not rows: the tag must survive
        # migrations that re-home a name to a new row.
        self.response_cache: Dict[int, Tuple[float, Optional[str], str]] = {}
        # in-flight dedup (the reference's outstanding-table propose dedup,
        # PaxosManager.java:1209): a retransmitted request id whose original
        # proposal is still queued locally must not mint a second vid —
        # duplicate decisions of one logical request are legal but wasteful,
        # and post-jump replicas can't dedup them (no cache entry yet)
        self.inflight: Dict[int, int] = {}  # request_id -> queued vid
        self._next_counter = 1
        # node-minted request-id namespace: (boot nonce << 24) | counter,
        # < 2^61 (disjoint from reserved-bit-62 stop ids; client ids are
        # random 53+ bit — collision odds negligible either way)
        import random as _random

        self._rid_nonce = _random.randrange(1 << 20, 1 << 37)
        self.queues: Dict[int, List[int]] = {}  # group row -> pending vids
        # vid -> (name, epoch) it was proposed under (admission guard)
        self.vid_scope: Dict[int, Tuple[str, int]] = {}
        self.forward_out: List[Tuple[int, str, Dict]] = []  # (dst, kind, body)
        self._fired_callbacks: List[Tuple[Callable, int, Optional[str]]] = []
        self.app_exec_slot = np.zeros(G, np.int64)  # host app cursor per group
        # rows whose app cursor moved since the last gossip: the cursor
        # delta ships SPARSE (a full [G] list per tick is O(G) host work
        # and wire bytes for idle groups)
        self._app_exec_dirty: set = set()
        self.pending_exec: Dict[int, Dict[int, int]] = {}  # g -> slot -> vid
        # executed payloads retained for straggler pulls until every live
        # member's frontier passes the slot (sync/catch-up analog; a peer
        # down past a checkpoint catches up via checkpoint transfer instead)
        self.retained: Dict[int, Tuple[int, int]] = {}  # vid -> (row, slot)
        self._min_exec = np.zeros(G, np.int64)
        self._zero_cursors = np.zeros(G, np.int64)
        self.peer_app_exec: Dict[int, np.ndarray] = {}  # rid -> [G] cursors
        self._tick_no = 0
        self.total_executed = 0
        self._slots_since_ckpt = 0
        self.last_engine_step_s = 0.0
        # last tick where the engine made observable progress (admissions,
        # accepts, commits, ballot movement) — the server's event-kicked
        # cadence falls back to the timer when in-flight work stalls (a
        # minority partition must not busy-spin the loop)
        self.last_progress_tick = 0
        self._last_state_req: Dict[int, int] = {}  # row -> tick of last pull
        # rows whose app cursor is parked on a missing payload, and since
        # which tick: a payload GONE everywhere (GC'd before this member
        # joined) can park a cursor at a gap SMALLER than the ring/jump
        # horizons — after enough blocked ticks the state pull fires
        # regardless of gap size
        self._payload_blocked: Dict[int, Tuple[int, int]] = {}
        # rows whose DEVICE frontier has sat strictly behind the majority
        # frontier without progress: if the decisions they need left every
        # peer's window (majority paused + resumed at a higher frontier),
        # no gap is small enough to heal through the rings — after enough
        # stalled ticks the row both fires a state pull and ACCEPTS a
        # small-gap jump (chaos find).  Vectorized (arm tick / armed
        # slot per row; -1 = disarmed): during a mass catch-up every
        # lagging row updates each tick, which a Python dict cannot afford
        self._stall_since = np.full(G, -1, np.int64)
        self._stall_slot = np.full(G, -1, np.int64)
        # rows that joined an epoch > 0 WITHOUT state (membership heal /
        # resume fallback): their logical app state is the previous
        # epoch's final state, which no frontier counter reflects — with
        # zero post-join traffic the frontiers MATCH and the ordinary
        # straggler pull never fires.  Flagged rows pull state and adopt
        # a donor's app state even at EQUAL frontiers.
        self._needs_state: set = set()

        # recovery plane: rows whose app state is still on disk (their
        # checkpoint shard is the idle form, like a paused group's
        # journal record) — gated out of admission, execution, local
        # reads, pause snapshots, checkpoint writes, and donor serving
        # until the hydrator restores them
        self.hydrating_rows: set = set()
        self.hydrator = None  # recovery.hydration.Hydrator while cold
        self._recovery_stats: Dict[str, Any] = {}

        # serializes self.state replacement between the tick loop and
        # lifecycle ops arriving on transport threads (create/kill/recover)
        self._state_lock = threading.RLock()
        # double-buffered dispatch (serving pipeline): True from
        # step_dispatch until step_complete's post-step lands.  The HOT
        # transport entry points (propose / payload gossip) interleave
        # freely with the in-flight device step — only ops that REPLACE
        # engine state or read step-ordering-sensitive tables wait on the
        # condition (they would otherwise race the post-step bookkeeping
        # for rows the step just committed)
        self._step_cv = threading.Condition(self._state_lock)
        self._step_inflight = False
        self._step_thread: Optional[int] = None  # owner of the in-flight step
        # host mirror of engine leaves, keyed by state identity: hot
        # accessors (coordinator_of_row / current_epoch / is_stopped, the
        # propose path) must not force a whole-array device->host transfer
        # per CALL — that is O(calls * G) traffic (VERDICT r2 weak #3)
        self._np_cache: Dict[str, np.ndarray] = {}
        self._np_cache_state: Optional[EngineState] = None
        self.state: EngineState = init_state(cfg, self.device)
        self._recover()

    def _np(self, leaf: str) -> np.ndarray:
        """Cached host copy of an engine leaf for the CURRENT state object
        (one transfer per leaf per state version, not per accessor call).
        Takes the state lock: an unlocked reader racing the tick thread's
        state replacement could otherwise store an OLD state's array under
        the NEW state's cache and poison every later reader.

        The returned array is always a PRIVATE host copy: on the CPU a
        tensor's ``.numpy()`` shares its memory, and the dispatch step
        donates the state, so a view held by a transport thread past its
        lock region would read buffers a later tick overwrites."""
        with self._state_lock:
            if self._np_cache_state is not self.state:
                self._np_cache = {}
                self._np_cache_state = self.state
            arr = self._np_cache.get(leaf)
            if arr is None:
                arr = to_host(getattr(self.state, leaf))
                self._np_cache[leaf] = arr
            return arr

    # ------------------------------------------------------------------
    # recovery (initiateRecovery analog, PaxosManager.java:1832-2035)
    # ------------------------------------------------------------------
    def _recover(self) -> None:
        if self.logger is None:
            return
        t_recover = time.monotonic()
        seed = {k: to_host(v) for k, v in self.state._asdict().items()}
        rec = self.logger.recover(
            self.cfg.window, seed_arrays=seed, my_id=self.my_id,
            defer_app_states=Config.get_bool(PC.RECOVERY_LAZY_HYDRATION),
        )
        if rec.arrays is None:
            return
        # checkpoints written before the tag lane existed lack the key —
        # seed zeros here; the authoritative recompute below overwrites
        rec.arrays.setdefault("tag", seed["tag"])
        self.state = EngineState(
            **{k: _dev(v, torch.int32, self.device)
               for k, v in rec.arrays.items()}
        )
        meta = rec.meta
        for k, v in (meta.get("arena") or {}).items():
            self.arena.setdefault(int(k), v)
        for k, v in (meta.get("vid_meta") or {}).items():
            self.vid_meta.setdefault(int(k), (v[0], v[1]))
        self.arena.update(rec.payloads)  # journal blocks are newer
        for k, v in rec.payload_meta.items():
            self.vid_meta.setdefault(int(k), (int(v[0]), int(v[1])))
        for rid_s, ent in (meta.get("response_cache") or {}).items():
            # exactly-once dedup survives restarts (the restored app
            # state's history includes these executions)
            self.response_cache.setdefault(
                int(rid_s), (float(ent[0]), ent[1], str(ent[2]))
            )
        self.names = {str(k): int(v) for k, v in meta.get("names", {}).items()}
        self.old_epochs = {
            (str(n), int(e)): int(r)
            for n, e, r in meta.get("old_epochs", [])
        }
        versions = self._np("version")
        masks = self._np("member_mask")
        journal_inits: Dict[str, Optional[str]] = {}
        for nm, ents in rec.names.items():  # creates after the checkpoint
            # entries replay in journal order; a later entry for the same
            # name is an epoch upgrade — the prior epoch's row is demoted
            # to old_epochs exactly as the live create path does
            for ent in ents:
                prev_row = self.names.get(nm)
                if prev_row is not None and prev_row != int(ent["row"]):
                    self.old_epochs[(nm, int(versions[prev_row]))] = prev_row
                self.names[nm] = int(ent["row"])
            journal_inits[nm] = ents[-1].get("init")
        # Interleaved KILL blocks (epoch drops / deletes) zeroed the killed
        # rows' member_mask in the arrays but the replay above can't see
        # them — filter mappings whose row was killed, and old-epoch claims
        # on rows that another (newer) name now occupies.
        self.names = {
            n: r for n, r in self.names.items() if int(masks[r]) != 0
        }
        live_rows = set(self.names.values())
        self.old_epochs = {
            (n, e): r for (n, e), r in self.old_epochs.items()
            if int(masks[r]) != 0 and r not in live_rows
        }
        self.row_name = {v: k for k, v in self.names.items()}
        for (nm, e), r in self.old_epochs.items():
            self.row_name[r] = nm
        self.pending_rows = {
            int(r) for r in rec.pending_rows if r in live_rows
        }
        # blank-join rows still awaiting a donor's state survive restarts:
        # seed from the checkpoint meta, plus infer journal-replayed
        # creates at epoch > 0 with no initial state (a legit None final
        # state just costs one redundant pull that adopts the same None)
        self._needs_state = {
            int(r) for r in (meta.get("needs_state") or [])
            if int(r) in live_rows
        }
        for nm, init in journal_inits.items():
            r = self.names.get(nm)
            if r is not None and init is None and int(versions[r]) > 0:
                self._needs_state.add(r)
        self._next_counter = int(meta.get("next_counter", 1))
        for vid in rec.payloads:
            base = vid & ~(STOP_BIT | BATCH_BIT)
            if (base >> VID_NODE_SHIFT) == self.my_id:
                self._next_counter = max(
                    self._next_counter, (base & VID_COUNTER_MASK) + 1
                )
        ae = meta.get("app_exec_slot")
        if ae is not None:
            self.app_exec_slot = np.asarray(ae, np.int64)
        else:
            self.app_exec_slot = (
                self._np("exec_slot").astype(np.int64).copy()
            )
        for g_str, pend in (meta.get("pending_exec") or {}).items():
            self.pending_exec[int(g_str)] = {
                int(s_): int(v) for s_, v in pend.items()
            }
        # stopped prior epochs never execute further on the host: the new
        # epoch's restore subsumed their trailing slots, and re-executing
        # them here would double-apply onto the restored app state
        exec_np = self._np("exec_slot")
        for (_nm, _e), r in self.old_epochs.items():
            self.app_exec_slot[r] = int(exec_np[r])
            self.pending_exec.pop(r, None)
        app_states = meta.get("app_states") or {}
        # lazy mode: the checkpoint's app states stayed on disk
        # (rec.view); its NAME DOMAIN still decides precedence exactly as
        # the eager restore would (checkpoint state wins over a replayed
        # create's init), the restore itself just happens at hydration
        ck_domain = (
            set(rec.view.meta.get("names") or ())
            if rec.view is not None else set()
        )
        for name, state_str in app_states.items():
            if name in self.names:
                self.app.restore(name, state_str)
        for name, init in journal_inits.items():
            if name not in app_states and name not in ck_domain:
                self.app.restore(name, init)
        # residency: fold pause records (LAST — checkpoint app-state and
        # cursor restoration above must not overwrite the fold).  A name
        # live at the same epoch was RESUMED: the pause record's frontier /
        # ballot / app state must survive (the resume-create replays empty,
        # and a forgotten promise could accept an older-ballot proposal).
        # A name not live stays paused and reactivates from self.paused.
        arrays = None
        fold_restored: set = set()  # names whose app state the fold set
        for (nm, e), prec in rec.pause_records.items():
            r = self.names.get(nm)
            if r is not None and int(versions[r]) == e:
                if arrays is None:
                    arrays = {
                        k: to_host(v)
                        for k, v in self.state._asdict().items()
                    }
                # the safety bits (promised ballot, accepted/decided window
                # remnants) fold even at EQUAL frontiers — a record with
                # exec == replayed frontier can still carry a promise the
                # replayed create forgot (bal bumped without execution)
                if int(prec["exec"]) >= int(arrays["exec_slot"][r]):
                    arrays["bal"][r] = max(int(arrays["bal"][r]), int(prec["bal"]))
                    for slot, b, vid in prec.get("acc") or []:
                        lane = slot % self.cfg.window
                        if slot > int(arrays["acc_slot"][r, lane]):
                            arrays["acc_slot"][r, lane] = slot
                            arrays["acc_bal"][r, lane] = b
                            arrays["acc_vid"][r, lane] = vid
                    for slot, vid in prec.get("dec") or []:
                        lane = slot % self.cfg.window
                        if slot > int(arrays["dec_slot"][r, lane]):
                            arrays["dec_slot"][r, lane] = slot
                            arrays["dec_vid"][r, lane] = vid
                if int(prec["exec"]) > int(arrays["exec_slot"][r]):
                    arrays["exec_slot"][r] = int(prec["exec"])
                    arrays["app_hash"][r] = int(prec["app_hash"])
                    arrays["n_execd"][r] = int(prec["n_execd"])
                    self.app.restore(nm, prec.get("app_state"))
                    fold_restored.add(nm)
                    # the snapshotted app state corresponds to the
                    # record's APP cursor, which a forced pause can leave
                    # behind the device frontier; pairing the state with
                    # "exec" would skip the gap's executions silently.
                    # The stranded gap is unexecutable locally (see the
                    # resume_group comment) — park for a donor pull
                    self.app_exec_slot[r] = int(
                        prec.get("app_exec", prec["exec"])
                    )
                    if int(self.app_exec_slot[r]) < int(prec["exec"]):
                        self._needs_state.add(r)
                    self.pending_exec.pop(r, None)
                    for rid_s, ent in (prec.get("dedup") or {}).items():
                        self.response_cache.setdefault(
                            int(rid_s), (float(ent[0]), ent[1], str(ent[2]))
                        )
            elif nm not in self.names:
                self._paused_put((nm, e), prec)
        # Roll the execute frontier forward through EVERY journaled
        # decision (the rings only hold the last W per group — a group
        # that decided more than W slots since its checkpoint would
        # otherwise wedge at the snapshot frontier forever).  The device
        # hash chain advances with the same fold the engine uses; host
        # execution happens via pending_exec on the first ticks.
        if rec.decisions:
            if arrays is None:
                arrays = {
                    k: to_host(v)
                    for k, v in self.state._asdict().items()
                }
            old_rows = set(self.old_epochs.values())
            for g, decs in rec.decisions.items():
                if int(masks[g]) == 0 or g in old_rows:
                    continue  # killed / stopped-prior-epoch rows stay put
                s = int(arrays["exec_slot"][g])
                h = int(arrays["app_hash"][g])
                ne = int(arrays["n_execd"][g])
                base = s
                while s in decs:
                    vid = decs[s]
                    if vid > 0:
                        h = _mix32(h, vid)
                        ne += 1
                    s += 1
                if s > base:
                    arrays["exec_slot"][g] = s
                    arrays["app_hash"][g] = h
                    arrays["n_execd"][g] = ne
                    arrays["c_next_slot"][g] = max(
                        int(arrays["c_next_slot"][g]), s
                    )
                pend = self.pending_exec.setdefault(g, {})
                cursor = int(self.app_exec_slot[g])
                for slot, vid in decs.items():
                    if slot >= cursor:
                        pend.setdefault(slot, vid)
                if not pend:
                    del self.pending_exec[g]
        if arrays is not None:
            self.state = EngineState(
                **{k: _dev(v, torch.int32, self.device)
                   for k, v in arrays.items()}
            )
        # instance tags are derivable state — recompute from the restored
        # name map rather than trusting the checkpoint (also upgrades
        # checkpoints written before the tag lane existed, which restore
        # as zeros and would freeze every group's consensus)
        tags = to_host(self.state.tag)
        versions = self._np("version")
        for nm, r in self.names.items():
            tags[r] = _instance_tag(nm, int(versions[r]))
        for (nm, e), r in self.old_epochs.items():
            tags[r] = _instance_tag(nm, int(e))
        self.state = self.state._replace(
            tag=_dev(tags, torch.int32, self.device)
        )
        # ---- lazy hydration plan (recovery plane) ---------------------
        # Checkpoint-domain names not already restored above go COLD:
        # their rows gate out of admission/execution/reads until the
        # hydrator restores them.  The recency-ordered hot set (manifest
        # hints) hydrates NOW — that is the bounded restart-to-serving
        # window — and the rest restores in the background.
        hot_hydrated = 0
        if rec.view is not None:
            from .recovery.hydration import Hydrator

            hyd = Hydrator(
                self, rec.view,
                batch=Config.get_int(PC.RECOVERY_HYDRATION_BATCH),
            )
            # the view's engine arrays were already folded into
            # self.state above; keeping them pinned through the whole
            # hydration window would carry a duplicate [G,...] host
            # copy (hundreds of MB at 256k groups) for nothing
            rec.view.arrays = {}
            ck_rows = rec.view.meta.get("names") or {}
            for nm, row in self.names.items():
                if nm in fold_restored or nm not in ck_domain:
                    continue
                self.hydrating_rows.add(row)
                hyd.add_cold(
                    nm, rec.view.shard_of_row(int(ck_rows.get(nm, row)))
                )
            hot_budget = Config.get_int(PC.RECOVERY_HOT_NAMES)
            for row in rec.view.meta.get("hot_rows") or ():
                if hot_budget <= 0 or not hyd.backlog:
                    break
                nm = self.row_name.get(int(row))
                if nm is not None and int(row) in self.hydrating_rows:
                    hyd.hydrate_name_locked(nm)
                    hot_budget -= 1
                    hot_hydrated += 1
            # hint-less checkpoints (pre-manifest or first generation)
            # still serve a bounded hot set, in shard order
            while hot_budget > 0 and hyd.backlog:
                nm = hyd._pop()
                if nm is None:
                    break
                hyd.hydrate_name_locked(nm)
                hot_budget -= 1
                hot_hydrated += 1
            if hyd.backlog:
                self.hydrator = hyd
        # synchronous rollforward through the app (initiateRecovery parity
        # for everything hydrated; cold rows park their decided slots in
        # pending_exec until hydration); slots whose payloads are not
        # local stay pending and heal via runtime peer pulls
        self._drain_pending_exec()
        self._fired_callbacks.clear()  # no clients to answer at recovery
        # first tick gossips a cursor baseline for everything live here
        self._app_exec_dirty.update(self.names.values())
        self._app_exec_dirty.update(self.old_epochs.values())
        # recovery accounting: the obs counters + `stats` phase surface
        st = dict(getattr(rec, "stats", None) or {})
        st["time_to_first_serve_s"] = time.monotonic() - t_recover
        st["hot_hydrated"] = hot_hydrated
        st["cold_backlog_at_serve"] = (
            self.hydrator.backlog if self.hydrator else 0
        )
        self._recovery_stats = st
        mx = self.metrics
        mx.count("recovery_segments_replayed", st.get("segments", 0))
        mx.count("recovery_blocks_replayed", st.get("blocks", 0))
        mx.gauge("recovery_replay_s", st.get("replay_s", 0.0))
        mx.gauge("recovery_time_to_first_serve_s",
                 st["time_to_first_serve_s"])
        mx.gauge("recovery_hydration_backlog", st["cold_backlog_at_serve"])
        if self.hydrator is not None:
            self.hydrator.start_background()

    # ------------------------------------------------------------------
    # recovery-plane surface (phase + stats + read gate)
    # ------------------------------------------------------------------
    @property
    def recovery_phase(self) -> str:
        """``recovering`` while any name's app state is still on disk;
        ``serving`` once hydration drained.  The launcher's readiness
        wait and the ``stats`` admin op read this."""
        return "recovering" if self.hydrating_rows else "serving"

    def recovery_stats(self) -> Dict[str, Any]:
        out = dict(self._recovery_stats)
        out["phase"] = self.recovery_phase
        out["hydration_backlog"] = (
            self.hydrator.backlog if self.hydrator else 0
        )
        out["hydrated"] = (
            self.hydrator.n_hydrated if self.hydrator
            else self._recovery_stats.get("hot_hydrated", 0)
        )
        return out

    def mesh_info(self) -> Dict[str, Any]:
        """{n_devices, shape, platform} of the devices backing the engine
        state — surfaced on the ``stats`` admin op so an accidentally
        unsharded deployment (a G meant for a mesh sitting on one device)
        is visible at runtime, not discovered in an OOM."""
        from .parallel.mesh import describe_state_mesh

        return describe_state_mesh(self.state.bal)

    # ------------------------------------------------------------------
    # device-plane observatory (obs/device.py)
    # ------------------------------------------------------------------
    def pull_group_heat(self) -> np.ndarray:
        """Drain the device-resident ``[G]`` activity accumulator.

        THE one sanctioned device pull outside the `_np` leaf cache —
        stats-cadence only (the server's stats line / the `stats` admin
        op), never from a hot-path function: it synchronizes with an
        in-flight dispatch.  Returns the per-group delta since the last
        pull, folds it into the cumulative host view and the
        ``group_heat*`` metrics, and resets the device accumulator."""
        from .obs.device import HEAT_BOUNDS, heat_summary

        with self._state_lock:
            # syncs; a private copy — the next dispatch donates the buffer
            arr = to_host(self._heat_dev)
            self._heat_dev = torch.zeros(
                (self.cfg.n_groups,), dtype=torch.int32, device=self.device
            )
            delta = arr.astype(np.int64)
            self._heat_host += delta
            cum = self._heat_host
        mx = self.metrics
        total = int(delta.sum())
        if total:
            mx.count("group_heat_total", total)
            mx.observe_bulk(
                "group_heat", delta[delta > 0], bounds=HEAT_BOUNDS
            )
        summ = heat_summary(cum)
        mx.gauge("group_heat_active_groups", summ["active_groups"])
        mx.gauge(
            "group_heat_top1pct_share",
            summ["hot_set"]["traffic_share"],
        )
        return delta

    def group_heat_stats(self, topk: Optional[int] = None) -> Dict:
        """The ``engine.heat`` stats block: top-K rows by cumulative
        activity (named where this node hosts the row) and the hot-set
        estimate the density campaign reads.  Pure host arithmetic over
        the last pulled view — call :meth:`pull_group_heat` first for a
        fresh one."""
        from .obs.device import heat_summary

        if topk is None:
            topk = Config.get_int(PC.GROUP_HEAT_TOPK)
        with self._state_lock:
            cum = self._heat_host.copy()
        return heat_summary(cum, topk=topk, name_of=self.row_name.get)

    def engine_compile_stats(self) -> Dict:
        """The ``engine.compile`` stats block: compile/retrace counts of
        this manager's two step instances (shared across same-shape
        managers in-process) plus their last recorded events."""
        return {
            "dispatch": self._dispatch_step.stats(),
            "tick": self._tick_step.stats(),
        }

    def local_read_ok(self, name: str) -> bool:
        """Gate for the uncoordinated local-read fast path: False while
        the name's app state is un-hydrated (and promotes it to the
        front of the hydration queue — a request touched it), and False
        while a transaction holds the name locked/staged (txn/app.py) —
        the read then serializes through consensus, where it is refused
        retryably until the transaction's decision lands."""
        blocked = getattr(self.app, "txn_local_read_blocked", None)
        if blocked is not None and blocked(name):
            return False
        row = self.names.get(name)
        if row is None or row not in self.hydrating_rows:
            return True
        if self.hydrator is not None:
            self.hydrator.request(name)
        return False

    def hydrate_all(self, deadline_s: Optional[float] = None) -> bool:
        """Drain the hydration backlog synchronously (close paths,
        tests); True when nothing is left cold."""
        if self.hydrator is None:
            return not self.hydrating_rows
        return self.hydrator.drain(deadline_s)

    # ------------------------------------------------------------------
    # lifecycle (createPaxosInstance / kill, PaxosManager.java:611,2142)
    # ------------------------------------------------------------------
    def default_row_for(self, name: str) -> int:
        """Deterministic row proposal: stable hash + linear probe over THIS
        node's occupancy.  Only valid on the node initiating the create —
        the chosen row must then be propagated in the create request so
        every member maps the name to the SAME row (rows are the
        cross-replica alignment key of the batched arrays; the reference
        needs no such step because it keys everything by paxosID string)."""
        import zlib

        if name in self.names:
            return self.names[name]  # idempotent re-create (e.g. recovery)
        G = self.cfg.n_groups
        row = zlib.crc32(name.encode("utf-8")) % G
        for _ in range(G):
            if row not in self.row_name:
                return row
            row = (row + 1) % G
        raise RuntimeError("group capacity exhausted")

    def create_paxos_instance(
        self,
        name: str,
        members: List[int],
        initial_state: Optional[str] = None,
        version: int = 0,
        row: Optional[int] = None,
        pending: bool = False,
        dedup: Optional[Dict] = None,
    ) -> bool:
        """``dedup`` carries the exactly-once entries snapshotted WITH
        ``initial_state`` (an epoch-final-state handoff).  They install
        IF AND ONLY IF this call adopts the state — every install pairs
        with its restore.  An unpaired install (entries present, state
        not adopted) skip-executes decisions the app state does not
        contain and diverges the RSM (chaos seed 662625602)."""
        with self._state_lock:
            self._await_step_locked()
            return self._create_locked(
                name, members, initial_state, version, row, pending,
                dedup=dedup,
            )

    def _create_locked(
        self, name, members, initial_state, version, row, pending=False,
        dedup=None,
    ) -> bool:
        if len(members) > self.max_group_size:
            # MAX_GROUP_SIZE ceiling (PaxosConfig.java:532): an oversized
            # group would also overflow the 32-bit member mask
            return False
        # requests held behind the pending gate on a row the probe moved:
        # they follow the name to its new row (vids/payloads stay live)
        held_vids: List[int] = []
        if name in self.names:
            cur_row = self.names[name]
            cur_ver = int(self._np("version")[cur_row])
            if version < cur_ver:
                return False
            if version == cur_ver:
                if row is None or int(row) == cur_row:
                    # idempotent re-create (start-epoch retransmit); a
                    # committed retransmit (late-start) confirms the row
                    if not pending and cur_row in self.pending_rows:
                        self._unpend_locked(cur_row)
                    return True
                # Same-epoch row change: the reconfigurator's row probe
                # moved to a fresh row after a collision NACK from some
                # member.  Only safe while the row is still PENDING (the
                # admission gate guarantees nothing committed here); a
                # confirmed (unpended) or executed row must refuse as a
                # collision so the RC's probe converges back to this row.
                if cur_row not in self.pending_rows or \
                        int(self._np("n_execd")[cur_row]):
                    raise RuntimeError(
                        f"row move for {name!r} v{version} refused: row "
                        f"{cur_row} is confirmed or already executed"
                    )
                held_vids = list(self.queues.get(cur_row, []))
                self._kill_locked(name, release_queue=False)
            else:
                # Epoch upgrade (reconfiguration): the stopped prior epoch's
                # row stays resident under (name, old_epoch) until the
                # reconfigurator drops it; the name re-maps to the new row
                # (PaxosManager's paxosID+version instance keying analog).
                if not int(self._np("stopped")[cur_row]):
                    return False  # old epoch must stop before the next starts
                self.old_epochs[(name, cur_ver)] = cur_row
                # row_name keeps the REAL name (occupancy only needs the key);
                # trailing executions of the old row must see the true
                # paxos_id, not a mangled alias
                del self.names[name]
                # The new epoch's initial state (the stop-time final state)
                # subsumes any of the old row's decided-but-unexecuted slots;
                # executing them after the restore would double-apply them.
                self.pending_exec.pop(cur_row, None)
                self._payload_blocked.pop(cur_row, None)
                self._stall_since[cur_row] = -1
                self._stall_slot[cur_row] = -1
                self._needs_state.discard(cur_row)
                # epoch upgrade supersedes a cold row's checkpoint state
                # (the new epoch restores from the stop-time final state)
                self.hydrating_rows.discard(cur_row)
                self.app_exec_slot[cur_row] = int(
                    self._np("exec_slot")[cur_row]
                )
        row = self.default_row_for(name) if row is None else int(row)
        if row in self.row_name:
            # collision-NACK path: the name (if it was re-homed above) is
            # already killed and cannot be re-queued here — release its
            # held vids so client retransmits re-propose after the RC's
            # next probe lands, instead of deduping against dead vids
            for vid in held_vids:
                self._release_vid(vid)
            raise RuntimeError(
                f"row {row} already hosts {self.row_name[row]!r} (create for "
                f"{name!r} must carry the creator's row)"
            )
        self.names[name] = row
        self.row_name[row] = name
        if pending:
            self.pending_rows.add(row)
        mask = 0
        for m in members:
            mask |= 1 << m
        coord0 = members[row % len(members)]
        self.state = create_groups(
            self.state, np.array([row]), np.array([mask]),
            np.array([coord0]), my_id=self.my_id, version=version,
            tag=_instance_tag(name, version),
        )
        # the implicit initial ballot (0, coord0) is known host-side:
        # seed the decide-attribution view without touching the device
        self._bal_host[row] = encode_ballot(0, coord0)
        self.app_exec_slot[row] = 0
        self._release_row_queue(row)  # stale leftovers of a prior tenant
        self.pending_exec.pop(row, None)
        # gossiped peer cursors for this row described its PREVIOUS
        # tenant (the merge is max-only); keeping them would both pin the
        # payload-retention watermark wrongly and false-arm the
        # frontier-stall detector against a frontier that never existed
        for arr in self.peer_app_exec.values():
            arr[row] = 0
        self._stall_since[row] = -1
        self._stall_slot[row] = -1
        self.row_activity[row] = time.time()
        if held_vids:
            self.queues[row] = held_vids
        if self.logger:
            self.logger.log_create(
                np.array([row]), np.array([mask]),
                np.array([version]), np.array([coord0]),
                names=[name], inits=[initial_state], pendings=[pending],
            )
        if self.my_id in members:
            self.app.restore(name, initial_state)
            # install paired with the restore just above — and ONLY here:
            # the idempotent/early returns above adopt no state, so
            # installing there would be the unpaired-install breach.  A
            # None state pairs too: its dedup snapshot describes the
            # history that ENDED in None, exactly what members who lived
            # through the epoch hold
            if dedup:
                self.install_dedup(dedup)
        return True

    def create_paxos_batch(
        self,
        names: List[str],
        members: List[int],
        initial_states: Optional[Dict[str, Optional[str]]] = None,
    ) -> int:
        """Bulk epoch-0 creation: ONE vectorized engine update and ONE
        journal block pair for N fresh names (the bootstrap/bench path —
        per-name creates cost a device dispatch each, which at 256k
        groups is minutes of pure dispatch overhead).  Names already
        present are skipped; returns how many were created."""
        if len(members) > self.max_group_size:
            return 0
        initial_states = initial_states or {}
        mask = 0
        for mem in members:
            mask |= 1 << mem
        with self._state_lock:
            self._await_step_locked()
            rows, coords, tags, fresh = [], [], [], []
            try:
                for name in names:
                    if name in self.names:
                        continue
                    row = self.default_row_for(name)
                    self.names[name] = row
                    self.row_name[row] = name
                    rows.append(row)
                    coords.append(members[row % len(members)])
                    tags.append(_instance_tag(name, 0))
                    fresh.append(name)
            except RuntimeError:
                # capacity exhausted mid-batch: the names mapped so far
                # have NO engine rows / journal entries yet — unwinding
                # them keeps the table consistent (nothing durable or
                # on-device happened), then the caller sees the error
                for name, row in zip(fresh, rows):
                    del self.names[name]
                    del self.row_name[row]
                raise
            if not fresh:
                return 0
            rows_np = np.array(rows, np.int32)
            self.state = create_groups(
                self.state, rows_np, np.full(len(rows), mask, np.int32),
                np.array(coords, np.int32), my_id=self.my_id, version=0,
                tag=np.array(tags, np.int32),
            )
            self.app_exec_slot[rows_np] = 0
            self._stall_since[rows_np] = -1
            self._stall_slot[rows_np] = -1
            self.row_activity[rows_np] = time.time()
            for arr in self.peer_app_exec.values():
                arr[rows_np] = 0
            for row in rows:
                self._release_row_queue(row)
                self.pending_exec.pop(row, None)
            if self.logger:
                self.logger.log_create(
                    rows_np, np.full(len(rows), mask, np.int32),
                    np.zeros(len(rows), np.int32),
                    np.array(coords, np.int32),
                    names=fresh,
                    inits=[initial_states.get(n) for n in fresh],
                )
            if self.my_id in members:
                for name in fresh:
                    self.app.restore(name, initial_states.get(name))
            return len(fresh)

    def commit_row(self, name: str, epoch: int, row: Optional[int] = None) -> None:
        """The reconfigurator's COMPLETE confirmed (name, epoch) at `row`:
        clear the admission gate (durably).  The row check matters: a
        laggard still holding a LOSING row for this epoch must not un-pend
        it — that row may alias another group on its peers; the committed
        late-start recreates it at the winning row instead."""
        with self._state_lock:
            cur = self.names.get(name)
            if cur is None or cur not in self.pending_rows:
                return
            if int(self._np("version")[cur]) != int(epoch):
                return
            if row is not None and int(row) >= 0 and int(row) != cur:
                return
            self._unpend_locked(cur)

    def _unpend_locked(self, row: int) -> None:
        self.pending_rows.discard(row)
        if self.logger:
            self.logger.log_unpend(np.array([row]))

    def _release_vid(self, vid: int) -> None:
        """Release one dead proposal's scheduling state so a retransmitted
        request id RE-PROPOSES instead of being deduped against it forever
        (the propose gate treats any vid still in vid_meta as live).
        Decided vids stay owned by retention GC."""
        if vid in self.retained:
            return
        payload = self.arena.pop(vid, None)
        if (vid & BATCH_BIT) and payload is not None:
            # release every member request's in-flight gate so their
            # retransmits re-propose instead of waiting on a dead batch
            try:
                for rid, _entry, _value in decode_batch(payload):
                    if self.inflight.get(rid) == vid:
                        del self.inflight[rid]
            except (ValueError, TypeError):
                pass  # undecodable batch: the %64 inflight sweep heals
        self.vid_scope.pop(vid, None)
        _entry, rid = self.vid_meta.pop(vid, (None, None))
        if rid is not None and self.inflight.get(rid) == vid:
            del self.inflight[rid]

    def _release_row_queue(self, row: int) -> None:
        """Drop a row's queue, releasing every queued vid."""
        for vid in self.queues.pop(row, None) or []:
            self._release_vid(vid)

    def kill(self, name: str) -> bool:
        with self._state_lock:
            self._await_step_locked()
            return self._kill_locked(name)

    def _kill_locked(self, name: str, release_queue: bool = True) -> bool:
        # release_queue=False is for pause / re-home callers, which have
        # snapshotted the queue for later re-queueing and need the vids'
        # scheduling state (meta, inflight dedup, callbacks) to survive
        row = self.names.pop(name, None)
        if row is None:
            return False
        del self.row_name[row]
        self.pending_rows.discard(row)
        self.hydrating_rows.discard(row)  # killed cold name: state is moot
        self._payload_blocked.pop(row, None)
        self._stall_since[row] = -1
        self._stall_slot[row] = -1
        self._needs_state.discard(row)
        self.state = kill_groups(self.state, np.array([row]))
        if self.logger:
            self.logger.log_kill(np.array([row]))
        if release_queue:
            self._release_row_queue(row)
        else:
            self.queues.pop(row, None)
        self.pending_exec.pop(row, None)
        return True

    def kill_epoch(self, name: str, epoch: int, final: bool = False) -> bool:
        """Free a stopped prior epoch's row (DropEpochFinalState analog:
        the reconfigurator garbage-collects the old epoch once the new one
        is running).  ``final``: the caller knows a majority executed the
        epoch's stop (a reconfigurator's drop), so this member's current
        row is freed even if it has not executed the stop itself — once
        its peers drop their rows it never could (the JAX package's
        manager refuses, and such a laggard keeps its row forever)."""
        with self._state_lock:
            self._await_step_locked()
            # a paused group being deleted has no row — drop the record
            # with a journal tombstone (else the PAUSE block resurrects it
            # on recovery, and a later re-created incarnation of the name
            # could restore the dead incarnation's state)
            prec = self._paused_pop((name, int(epoch)))
            if prec is not None:
                # its shadow queue dies with it: release so retransmits of
                # those request ids re-propose into the next incarnation
                for vid in prec.get("held_vids") or []:
                    self._release_vid(vid)
                if self.logger:
                    self.logger.log_pause({
                        "name": name, "epoch": int(epoch), "dropped": True,
                    })
            row = self.old_epochs.pop((name, epoch), None)
            if row is None:
                # dropping the current epoch is only legal if it's stopped
                # and matches (delete-service path)
                cur = self.names.get(name)
                if cur is None:
                    return False
                if int(self._np("version")[cur]) != epoch:
                    return False
                if not int(self._np("stopped")[cur]) and not final:
                    return False  # never kill a live, unstopped group
                return self._kill_locked(name)
            del self.row_name[row]
            self.pending_rows.discard(row)
            self._payload_blocked.pop(row, None)
            self._stall_since[row] = -1
            self._stall_slot[row] = -1
            self._needs_state.discard(row)
            self.state = kill_groups(self.state, np.array([row]))
            if self.logger:
                self.logger.log_kill(np.array([row]))
            self._release_row_queue(row)
            self.pending_exec.pop(row, None)
            return True

    # ------------------------------------------------------------------
    # residency: pause / resume (syncAndDeactivate + unpause analog,
    # PaxosManager.java:2264-2392,2786-2881 — RC-coordinated here because
    # rows must stay aligned across replicas for the blob exchange)
    # ------------------------------------------------------------------
    def _paused_put(self, key: Tuple[str, int], rec: Dict) -> None:
        """Insert a pause record, keeping the by-name epoch mirror in
        sync (every ``self.paused`` mutation goes through _paused_put /
        _paused_pop — restore() resolves a name's epochs through the
        mirror instead of scanning millions of cold keys)."""
        self.paused[key] = rec
        self._paused_by_name.setdefault(key[0], set()).add(int(key[1]))

    def _paused_pop(self, key: Tuple[str, int]) -> Optional[Dict]:
        rec = self.paused.pop(key, None)
        if rec is not None:
            eps = self._paused_by_name.get(key[0])
            if eps is not None:
                eps.discard(int(key[1]))
                if not eps:
                    del self._paused_by_name[key[0]]
        return rec

    def pause_group(self, name: str, epoch: int, force: bool = False) -> str:
        """Free (name, epoch)'s row, snapshotting its state to the journal
        and `self.paused`.  Returns "ok", "unknown" (not hosted here — an
        already-paused or never-started member just acks), or "busy"
        (non-quiescent and not forced: traffic resumed, pause should be
        cancelled).  `force` carries window remnants into the record (used
        by re-homing, where quiescence can't be awaited)."""
        with self._state_lock:
            self._await_step_locked()
            row = self.names.get(name)
            if row is None:
                return "ok" if (name, int(epoch)) in self.paused else "unknown"
            if int(self._np("version")[row]) != int(epoch):
                return "unknown"
            if int(self._np("stopped")[row]):
                return "busy"  # stopping group: the delete path owns it
            if row in self.hydrating_rows:
                # a pause record snapshots app state — un-hydrated, the
                # snapshot would capture the pre-restore blank.  Busy is
                # transient: background hydration clears it
                return "busy"
            exec_now = int(self._np("exec_slot")[row])
            quiescent = (
                not self.queues.get(row)
                and not self.pending_exec.get(row)
                and int(self.app_exec_slot[row]) == exec_now
                and int(self._np("acc_slot")[row].max()) < exec_now
            )
            if not quiescent and not force:
                return "busy"
            rec = self._extract_record(name, int(epoch), row)
            held = list(self.queues.get(row, []))
            if held:
                # unadmitted requests survive the pause in the record's
                # shadow queue (journaled WITH the record — a crash while
                # paused must not drop them); the resume re-queues them.
                # Their admission scopes ride along: vid_scope is in-memory
                # only, and a scope-less resumed vid would bypass the
                # stale-vid admission guard after a crash
                rec["held_vids"] = held
                rec["held_scopes"] = {
                    str(v): list(self.vid_scope[v])
                    for v in held if v in self.vid_scope
                }
            if self.logger:
                self.logger.log_pause(rec)
            self._paused_put((name, int(epoch)), rec)
            self._kill_locked(name, release_queue=False)
            if not force:
                # a non-forced pause is the sweeper's capacity eviction
                # (forced ones are re-homes/hibernates, not evictions)
                self.metrics.count("pause_evictions")
            return "ok"

    def _extract_record(
        self, name: str, epoch: int, row: int,
        dedup: Optional[Dict] = None,
    ) -> Dict:
        """Snapshot one row for pause/re-home (HotRestoreInfo analog).
        Reads go through the ``_np`` leaf cache — one host transfer per
        leaf per state version, not per paused name (the old per-call
        ``np.asarray(leaf)`` copied whole [G, W] planes per pause; a
        density sweep pays extraction thousands of times per state).
        ``dedup`` lets a batch caller supply this name's exactly-once
        entries from ONE grouped response-cache pass instead of the
        per-name O(cache) scan of :meth:`dedup_for_name`."""
        exec_now = int(self._np("exec_slot")[row])
        acc = []
        dec = []
        acc_slot = self._np("acc_slot")[row]
        acc_bal = self._np("acc_bal")[row]
        acc_vid = self._np("acc_vid")[row]
        dec_slot = self._np("dec_slot")[row]
        dec_vid = self._np("dec_vid")[row]
        for lane in range(self.cfg.window):
            if int(acc_slot[lane]) >= exec_now:
                acc.append([int(acc_slot[lane]), int(acc_bal[lane]),
                            int(acc_vid[lane])])
            if int(dec_slot[lane]) >= exec_now:
                dec.append([int(dec_slot[lane]), int(dec_vid[lane])])
        return {
            "name": name, "epoch": epoch,
            "exec": exec_now,
            "bal": int(self._np("bal")[row]),
            "app_hash": int(self._np("app_hash")[row]),
            "n_execd": int(self._np("n_execd")[row]),
            "app_state": self.app.checkpoint(name),
            "app_exec": int(self.app_exec_slot[row]),
            "acc": acc, "dec": dec,
            "dedup": self.dedup_for_name(name) if dedup is None else dedup,
            # member set rides along so a LOCAL restore (hibernate wake-up)
            # needs no reconfigurator round to learn the group
            "members": self.get_replica_group(name),
        }

    def resume_group(
        self, name: str, epoch: int, members: List[int], row: int,
        pending: bool = True, initial_state: Optional[str] = None,
    ) -> bool:
        """Reactivate (name, epoch) at `row` (the RC's freshly probed row).

        Three cases: still hosting live (re-home: carry full state over),
        holding a pause record (restore it), or neither (fresh empty join —
        the straggler state-transfer heals it).  Raises RuntimeError when
        `row` is occupied by another group (-> collision NACK)."""
        epoch = int(epoch)
        with self._state_lock:
            self._await_step_locked()
            cur = self.names.get(name)
            if cur is not None:
                cur_ver = int(self._np("version")[cur])
                if cur_ver > epoch:
                    return False
                if cur_ver == epoch:
                    hosted = self.get_replica_group(name)
                    if int(row) == cur and hosted == sorted(
                        int(m) for m in members
                    ):
                        if not pending and cur in self.pending_rows:
                            self._unpend_locked(cur)
                        return True
                    # live re-home (new row) OR membership heal (same row,
                    # STALE member set — the record's actives are
                    # authoritative post-COMPLETE; a member keeping a
                    # divergent mask would ignore the true members' blobs
                    # forever): snapshot with window remnants, free the
                    # row, fall through to restore with the new set
                    if self.pause_group(name, epoch, force=True) != "ok":
                        return False
            rec = self._paused_pop((name, epoch))
            if int(row) in self.row_name:
                if rec is not None:
                    self._paused_put((name, epoch), rec)  # keep for next probe
                raise RuntimeError(
                    f"row {row} already hosts {self.row_name[int(row)]!r}"
                )
            if rec is None:
                # no local state at all: join with the birth state (if
                # the caller knows it) and heal via state transfer.
                # A REJOIN wipes the app back to the birth state, so
                # this member's OWN response-cache entries for the name
                # describe executions the adopted state does NOT contain
                # — kept, they would suppress re-executing those
                # decisions into the blank state and freeze the RSM
                # (audit-heal find: a rejoined member at exec==cursor
                # with an empty app state, forever).  Epoch>0 joins
                # adopt a donor's state+dedup wholesale via _needs_state;
                # epoch-0 rejoins rebuild by re-executing history.
                for rid in [
                    r for r, (_t, _resp, nm) in self.response_cache.items()
                    if nm == name
                ]:
                    del self.response_cache[rid]
                ok = self._create_locked(
                    name, members, initial_state, epoch, int(row), pending
                )
                if ok and epoch > 0 and initial_state is None:
                    # an epoch > 0 group's true app state is the previous
                    # epoch's final state — this join is BLANK and must
                    # adopt a donor's state even at equal frontiers
                    self._needs_state.add(int(row))
                return ok
            t0 = time.monotonic()
            ok = self._create_locked(
                name, members, rec.get("app_state"), epoch, int(row), pending
            )
            if not ok:
                self._paused_put((name, epoch), rec)
                return False
            r = int(row)
            # device install + host bookkeeping via the SAME helpers the
            # batch path uses: resume_group IS resume_group_batch at N=1
            # (bit-exact parity is pinned by tests/test_batched_unpause)
            self._install_records_device_locked([(r, rec)])
            self._resume_record_host_locked(r, rec, name, epoch)
            self.metrics.observe(
                "unpause_latency_s", time.monotonic() - t0
            )
            return True

    def _install_records_device_locked(
        self, batch: List[Tuple[int, Dict]]
    ) -> None:
        """Scatter N pause records' consensus remnants into rows JUST
        created by ``create_groups`` — ONE fused device update (one
        ``.at[rows].set`` per touched leaf) regardless of N.  The old
        per-name install round-tripped the WHOLE state through host
        numpy per resumed name; a 4096-name wake burst paid that 4096
        times."""
        n = len(batch)
        W = self.cfg.window
        rows = np.empty(n, np.int32)
        exec_ = np.empty(n, np.int32)
        bal = np.empty(n, np.int32)
        app_hash = np.empty(n, np.int32)
        n_execd = np.empty(n, np.int32)
        acc_bal = np.full((n, W), NULL, np.int32)
        acc_vid = np.full((n, W), NULL, np.int32)
        acc_slot = np.full((n, W), NULL, np.int32)
        dec_vid = np.full((n, W), NULL, np.int32)
        dec_slot = np.full((n, W), NULL, np.int32)
        for i, (r, rec) in enumerate(batch):
            rows[i] = r
            exec_[i] = int(rec["exec"])
            # the row's device ballot is the implicit initial (0, coord0)
            # from the create, mirrored host-side in _bal_host — the max
            # is computable without a device read
            bal[i] = max(int(self._bal_host[r]), int(rec["bal"]))
            app_hash[i] = int(rec["app_hash"])
            n_execd[i] = int(rec["n_execd"])
            for slot, b, vid in rec.get("acc") or []:
                lane = slot % W
                acc_slot[i, lane] = slot
                acc_bal[i, lane] = b
                acc_vid[i, lane] = vid
            for slot, vid in rec.get("dec") or []:
                lane = slot % W
                dec_slot[i, lane] = slot
                dec_vid[i, lane] = vid
        self.state = restore_paused_rows(
            self.state, rows, exec_, bal, app_hash, n_execd,
            acc_bal, acc_vid, acc_slot, dec_vid, dec_slot,
        )

    def _resume_record_host_locked(
        self, r: int, rec: Dict, name: str, epoch: int
    ) -> None:
        """Per-name host bookkeeping of a record restore (everything in
        the resume besides the device scatter).  Shared verbatim by the
        per-name and batched paths; item order in a batch matches the
        equivalent sequence of per-name resumes."""
        self.app_exec_slot[r] = int(rec.get("app_exec", rec["exec"]))
        self._app_exec_dirty.add(r)
        if int(self.app_exec_slot[r]) < int(rec["exec"]):
            # a FORCED pause snapshots non-quiescent rows, so the
            # record can carry app_exec < exec — but the decided
            # slots in between are in NEITHER the record (dec
            # remnants keep only >= exec) nor pending_exec (dropped
            # with the pause).  The cursor can never replay its way
            # forward, and the gap may sit under jump_horizon with
            # nothing payload-blocked, so no heal detector fires
            # (txn-soak find: a hibernated-mid-traffic member woke
            # with app_exec 24 slots behind a current device
            # frontier and stayed there forever).  Park the row as
            # needing donor state — the per-tick state pull + the
            # app_only adoption clause close the gap
            self._needs_state.add(r)
        # the resume ROLLS BACK to the snapshot, so this member's own
        # response-cache entries for executions AFTER the snapshot
        # describe state the restored app does not contain — kept, they
        # would skip-execute those decisions during catch-up and diverge
        # the RSM (txn-soak find: a forced mid-traffic hibernate on
        # one member, woken as a straggler, came back short one
        # committed transfer).  The snapshot's own paired dedup
        # reinstalls right below.
        for rid in [
            r2 for r2, (_t, _resp, nm) in self.response_cache.items()
            if nm == name
        ]:
            del self.response_cache[rid]
        self.install_dedup(rec.get("dedup"))
        # the _create_locked journal entry has the app state as init;
        # the consensus remnants need the pause record on replay too
        if self.logger:
            self.logger.log_pause(rec)
        held = rec.get("held_vids") or []
        if held:
            self.queues[r] = [v for v in held if v in self.arena]
            scopes = rec.get("held_scopes") or {}
            for v in self.queues[r]:
                sc = scopes.get(str(v))
                # pre-scope records default to the resumed instance's
                # own scope (they were queued on its row)
                self.vid_scope[v] = (
                    (str(sc[0]), int(sc[1])) if sc else (name, int(epoch))
                )
        # release ORPHANED vids: a proposal admitted from the queue
        # into the device ring before a FORCED pause is in neither
        # the held queue nor the record's window remnants — the
        # consensus copy is gone, but its scheduling state survived
        # the pause (release_queue=False).  Kept, the stale
        # inflight entry parks every retransmit of that request id
        # here AND poisons forward-dedup of fresh peer proposals
        # for the same id, wedging the group on it forever
        # (txn-soak find: a resolver's commit re-drive starved
        # through 4k+ retransmits).  Undecided-only: remnant and
        # retained (decided) vids keep their state
        # re-homed/preempted vids can sit in OTHER rows' queues —
        # anything still queued anywhere is live, not orphaned
        kept = {v for q in self.queues.values() for v in q}
        kept.update(v for _s, _b, v in (rec.get("acc") or []))
        kept.update(v for _s, v in (rec.get("dec") or []))
        for v in [
            v for v, (nm, _ep) in self.vid_scope.items()
            if nm == name and v not in kept and v not in self.retained
        ]:
            self._release_vid(v)
        now = time.time()
        self.row_activity[r] = now
        # eviction hysteresis: a just-woken name is exempt from the idle
        # sweep for PAUSE_EVICTION_HYSTERESIS_S even if its wake burst
        # already ended (pause/resume flap protection)
        self._resumed_at[name] = now

    def resume_group_batch(
        self,
        items: List[Tuple[str, int, List[int], int, bool]],
    ) -> Dict[str, bool]:
        """Batched unpause: wake N paused records in ONE fused device
        update — one ``create_groups`` + one ``restore_paused_rows``
        (two scatters per touched leaf total) instead of N per-name row
        installs.  ``items`` is ``[(name, epoch, members, row, pending)]``.

        Only the pure record-restore case batches (name not live here, a
        local pause record exists, the target row is free and unique
        within the batch); anything else — live re-home, recordless
        join, collisions — falls back to the per-name :meth:`resume_group`
        so the batch is an optimization, never a semantic fork.  Returns
        ``{name: ok}``."""
        t0 = time.monotonic()
        out: Dict[str, bool] = {}
        n_fast = 0
        deferred: List[Tuple[str, int, List[int], int, bool]] = []
        with self._state_lock:
            self._await_step_locked()
            fast: List[Tuple[str, int, List[int], int, bool]] = []
            claimed: set = set()
            for name, epoch, members, row, pending in items:
                epoch, row = int(epoch), int(row)
                members = [int(m) for m in members]
                if (
                    name not in self.names
                    and (name, epoch) in self.paused
                    and row not in self.row_name
                    and row not in claimed
                    and members
                    and len(members) <= self.max_group_size
                ):
                    claimed.add(row)
                    fast.append((name, epoch, members, row, bool(pending)))
                else:
                    deferred.append((name, epoch, members, row, pending))
            if fast:
                # fault the spilled records in with sorted sequential
                # segment reads, not one random read per name
                if hasattr(self.paused, "restore_batch"):
                    self.paused.restore_batch(
                        [(nm, ep) for nm, ep, _m, _r, _p in fast]
                    )
                batch: List[Tuple[int, Dict]] = []
                names_l: List[str] = []
                rows_l: List[int] = []
                masks: List[int] = []
                coords: List[int] = []
                vers: List[int] = []
                tags: List[int] = []
                pendings: List[bool] = []
                recs: List[Dict] = []
                metas: List[Tuple[str, int, List[int]]] = []
                for name, epoch, members, row, pending in fast:
                    rec = self._paused_pop((name, epoch))
                    if rec is None:  # vanished (concurrent drop): defer
                        deferred.append((name, epoch, members, row, pending))
                        continue
                    mask = 0
                    for m in members:
                        mask |= 1 << m
                    self.names[name] = row
                    self.row_name[row] = name
                    if pending:
                        self.pending_rows.add(row)
                    coord0 = members[row % len(members)]
                    self._bal_host[row] = encode_ballot(0, coord0)
                    self.app_exec_slot[row] = 0
                    self._release_row_queue(row)
                    self.pending_exec.pop(row, None)
                    for arr in self.peer_app_exec.values():
                        arr[row] = 0
                    self._stall_since[row] = -1
                    self._stall_slot[row] = -1
                    self.row_activity[row] = time.time()
                    names_l.append(name)
                    rows_l.append(row)
                    masks.append(mask)
                    coords.append(coord0)
                    vers.append(epoch)
                    tags.append(_instance_tag(name, epoch))
                    pendings.append(bool(pending))
                    recs.append(rec)
                    metas.append((name, epoch, members))
                    batch.append((row, rec))
                if batch:
                    rows_np = np.array(rows_l, np.int32)
                    self.state = create_groups(
                        self.state, rows_np,
                        np.array(masks, np.int32),
                        np.array(coords, np.int32),
                        my_id=self.my_id,
                        version=np.array(vers, np.int32),
                        tag=np.array(tags, np.int32),
                    )
                    if self.logger:
                        self.logger.log_create(
                            rows_np, np.array(masks, np.int32),
                            np.array(vers, np.int32),
                            np.array(coords, np.int32),
                            names=names_l,
                            inits=[rec.get("app_state") for rec in recs],
                            pendings=pendings,
                        )
                    for (name, _ep, members), rec in zip(metas, recs):
                        if self.my_id in members:
                            self.app.restore(name, rec.get("app_state"))
                    self._install_records_device_locked(batch)
                    for (row, rec), (name, epoch, _m) in zip(batch, metas):
                        self._resume_record_host_locked(
                            row, rec, name, epoch
                        )
                        out[name] = True
                    n_fast = len(batch)
        if n_fast:
            dt = time.monotonic() - t0
            # every name in the burst became available when the batch
            # completed: the burst wall time IS each name's wake latency
            # (deferred items observe inside their per-name resume)
            self.metrics.observe_bulk(
                "unpause_latency_s", [dt] * n_fast
            )
        # non-fast-path items: the per-name resume outside the batch
        # (it re-takes the lock; a collision NACK maps to False)
        for name, epoch, members, row, pending in deferred:
            try:
                out[name] = self.resume_group(
                    name, epoch, members, row, pending
                )
            except RuntimeError:
                out[name] = False
        return out

    # ------------------------------------------------------------------
    # hibernate / restore (checkpoint + sleep on disk; local wake-up —
    # PaxosManager.hibernate:2209-2227 / restore:2230-2252)
    # ------------------------------------------------------------------
    def hibernate(self, name: str) -> bool:
        """Checkpoint (name)'s current epoch durably and release the row
        AND its RAM — the instance sleeps on disk.  Unlike the
        RC-coordinated pause (capacity residency), this is a LOCAL op:
        the snapshot is forced (window remnants ride along), and
        :meth:`restore` wakes it locally from the journaled record with a
        full rollback to that snapshot, no reconfigurator round."""
        with self._state_lock:
            row = self.names.get(name)
            if row is None:
                return False
            epoch = int(self._np("version")[row])
        if self.pause_group(name, epoch, force=True) != "ok":
            return False
        # page the record out of RAM when the paused table can spill
        # (reference: softCrash removes the instance object entirely; the
        # journaled pause record is the disk copy that outlives us)
        if hasattr(self.paused, "demote"):
            self.paused.demote((name, epoch))
        return True

    def hibernate_batch(self, names: List[str]) -> int:
        """Hibernate MANY names: one batched extract off the cached host
        leaves, ONE fused ``kill_groups`` scatter, one sequential spill
        run.  Per-name :meth:`hibernate` costs a device kill dispatch per
        name — putting a 1M-name cold tail to sleep that way is minutes
        of pure dispatch overhead (the density campaign's boot path).
        Forced-pause semantics identical to :meth:`hibernate`: window
        remnants and held vids ride in the records.  Returns how many
        names went to sleep."""
        with self._state_lock:
            self._await_step_locked()
            versions = self._np("version")
            stopped = self._np("stopped")
            jobs: List[Tuple[str, int, int]] = []
            for name in names:
                row = self.names.get(name)
                if row is None or row in self.hydrating_rows:
                    continue  # not hosted / snapshot would be blank
                if int(stopped[row]):
                    continue  # stopping group: the delete path owns it
                jobs.append((name, int(versions[row]), row))
            if not jobs:
                return 0
            # ONE grouped pass over the response cache for every job's
            # dedup entries (the per-name scan is O(cache) each)
            wanted = {name for name, _e, _r in jobs}
            dedup_by_name: Dict[str, Dict] = {}
            for rid, (t, resp, nm) in self.response_cache.items():
                if nm in wanted:
                    dedup_by_name.setdefault(nm, {})[str(rid)] = [
                        t, resp, nm
                    ]
            rows_l: List[int] = []
            keys: List[Tuple[str, int]] = []
            for name, epoch, row in jobs:
                rec = self._extract_record(
                    name, epoch, row, dedup=dedup_by_name.get(name, {})
                )
                held = list(self.queues.get(row, []))
                if held:
                    rec["held_vids"] = held
                    rec["held_scopes"] = {
                        str(v): list(self.vid_scope[v])
                        for v in held if v in self.vid_scope
                    }
                if self.logger:
                    self.logger.log_pause(rec)
                self._paused_put((name, epoch), rec)
                rows_l.append(row)
                keys.append((name, epoch))
            rows_np = np.array(rows_l, np.int32)
            self.state = kill_groups(self.state, rows_np)
            if self.logger:
                self.logger.log_kill(rows_np)
            for name, _epoch, row in jobs:
                # host side of _kill_locked(release_queue=False), minus
                # the per-name device op the fused kill replaced
                self.names.pop(name, None)
                self.row_name.pop(row, None)
                self.pending_rows.discard(row)
                self.hydrating_rows.discard(row)
                self._payload_blocked.pop(row, None)
                self._stall_since[row] = -1
                self._stall_slot[row] = -1
                self._needs_state.discard(row)
                self.queues.pop(row, None)
                self.pending_exec.pop(row, None)
            # page the records out of RAM as one sequential append run
            if hasattr(self.paused, "demote_batch"):
                self.paused.demote_batch(keys)
            elif hasattr(self.paused, "demote"):
                for key in keys:
                    self.paused.demote(key)
            return len(jobs)

    def restore_batch(self, names: List[str]) -> int:
        """Wake MANY hibernated names via :meth:`resume_group_batch` —
        one fused device update for the whole burst, with the spilled
        records faulted in by sorted sequential segment reads.  Rows are
        the same deterministic ``default_row_for`` probe the per-name
        :meth:`restore` uses (intra-batch collisions probe onward).
        Returns how many names are awake afterward."""
        n_awake = 0
        items: List[Tuple[str, int, List[int], int, bool]] = []
        with self._state_lock:
            keys = []
            for name in names:
                if self.names.get(name) is not None:
                    n_awake += 1  # already awake
                    continue
                eps = self._paused_by_name.get(name)
                if eps:
                    keys.append((name, max(eps)))
            # fault the whole burst's records in sequentially, then read
            # the member sets the wake needs
            recs = (
                self.paused.restore_batch(keys)
                if hasattr(self.paused, "restore_batch")
                else {k: self.paused[k] for k in keys if k in self.paused}
            )
            import zlib

            G = self.cfg.n_groups
            claimed: set = set()
            for name, epoch in keys:
                rec = recs.get((name, epoch))
                members = rec.get("members") if rec else None
                if not members:
                    continue
                row = zlib.crc32(name.encode("utf-8")) % G
                for _ in range(G):
                    if row not in self.row_name and row not in claimed:
                        break
                    row = (row + 1) % G
                else:
                    break  # capacity exhausted: stop staging wakes
                claimed.add(row)
                items.append((name, epoch, members, row, False))
        if items:
            res = self.resume_group_batch(items)
            n_awake += sum(1 for ok in res.values() if ok)
        return n_awake

    def restore(self, name: str) -> bool:
        """Wake a hibernated instance: roll back to its journaled
        snapshot at a locally chosen row.  Row choice is the same
        deterministic ``default_row_for`` probe every member uses, so a
        cluster whose members hibernated/restored the same set of names
        re-aligns; deployments that cannot guarantee that use the
        RC-coordinated resume (which carries the row)."""
        with self._state_lock:
            if self.names.get(name) is not None:
                return True  # already awake
            # the by-name mirror, NOT a key scan: the paused table is the
            # cold tail (millions of names at density scale)
            epochs = self._paused_by_name.get(name)
        if not epochs:
            return False
        epoch = max(epochs)
        with self._state_lock:
            rec = self.paused.get((name, epoch))
            if rec is None:
                return False
            members = rec.get("members")
        if not members:
            return False
        try:
            row = self.default_row_for(name)
            return self.resume_group(name, epoch, members, row,
                                     pending=False)
        except RuntimeError:
            # capacity exhausted / row collision: a failed wake-up the
            # caller can retry after freeing rows, not a crash
            return False

    def pending_row_keys(self) -> List[Tuple[str, int, int]]:
        """(name, epoch, row) for every row still behind the pre-COMPLETE
        admission gate.  Normally transient; a row stuck here after its
        late-start retransmits expired is wedged (it refuses every
        proposal) and must ask the RC where the epoch really lives."""
        with self._state_lock:
            out = []
            versions = self._np("version")
            for row in self.pending_rows:
                name = self.row_name.get(row)
                if name is not None and self.names.get(name) == row:
                    out.append((name, int(versions[row]), int(row)))
            return out

    def drop_pending_row(self, name: str, epoch: int, row: int) -> None:
        """RC says this pending row's epoch is gone: free it."""
        with self._state_lock:
            self._await_step_locked()
            cur = self.names.get(name)
            if cur != int(row) or cur not in self.pending_rows:
                return
            if int(self._np("version")[cur]) != int(epoch):
                return
            self._kill_locked(name)

    def stopped_row_keys(self) -> List[Tuple[str, int]]:
        """(name, epoch) of CURRENT mappings whose epoch-final stop has
        executed.  A stopped current row is always awaiting an epoch
        transition (the delete's drop round, or an upgrade) — normally
        transient, but a drop can RACE residency: a member that acked
        the drop while paused (not hosting), then resumed and executed
        the stop, holds a live stopped row with no record and no
        bookkeeping left to clean it (chaos-sweep find: names lingering
        post-delete).  The epoch probe asks the RC about these."""
        out = []
        with self._state_lock:
            versions = self._np("version")
            stopped = self._np("stopped")
            for name, row in self.names.items():
                if int(stopped[row]):
                    out.append((name, int(versions[row])))
        return out

    def pause_record_keys(self) -> List[Tuple[str, int]]:
        """(name, epoch) of every locally held pause record (the AR layer
        probes the RC about them: a record the RC no longer knows is
        droppable; a record whose epoch is LIVE means an aborted pause
        round left this member frozen and it must rejoin)."""
        with self._state_lock:
            return [(str(n), int(e)) for (n, e) in self.paused]

    def drop_pause_record(self, name: str, epoch: int) -> None:
        with self._state_lock:
            self._paused_pop((name, int(epoch)))

    def dedup_for_name(self, name: str) -> Dict[str, list]:
        """This name's exactly-once entries, for shipping WITH any app
        -state handoff (epoch final state, pause record, state transfer):
        an adopted state without its dedup entries re-executes re-proposed
        duplicates; entries for other names suppress executions the
        adopted state lacks — both diverge the RSM."""
        with self._state_lock:
            return {
                str(rid): [t, resp, nm]
                for rid, (t, resp, nm) in self.response_cache.items()
                if nm == name
            }

    def install_dedup(self, entries: Optional[Dict]) -> None:
        now = time.time()
        with self._state_lock:
            for rid_s, ent in (entries or {}).items():
                self.response_cache.setdefault(
                    int(rid_s),
                    (min(float(ent[0]), now), ent[1], str(ent[2])),
                )

    def drain_demand(self) -> Dict[str, Tuple[int, int]]:
        """Take the per-name request counts since the last drain; returns
        {name: (count, epoch)} for current-epoch names."""
        with self._state_lock:
            counts, self.demand_counts = self.demand_counts, {}
            self.demand_backlog = 0
            versions = self._np("version")
            out = {}
            for name, n in counts.items():
                row = self.names.get(name)
                if row is not None:
                    out[name] = (n, int(versions[row]))
            return out

    def idle_names(self, idle_s: float) -> List[Tuple[str, int]]:
        """(name, epoch) of current-epoch groups with no traffic for
        `idle_s` seconds (Deactivator sweep candidates)."""
        out = []
        cut = time.time() - idle_s
        with self._state_lock:
            versions = self._np("version")
            for name, row in self.names.items():
                if row in self.pending_rows or self.queues.get(row):
                    continue
                if self.row_activity[row] < cut:
                    out.append((name, int(versions[row])))
        return out

    def eviction_candidates(
        self, idle_s: float, limit: Optional[int] = None,
    ) -> List[Tuple[str, int]]:
        """Admission-aware pause-eviction order for the idle sweeper:
        ``idle_names`` filtered and SORTED coldest-first — last-use wall
        time ascending, cumulative group heat (PR-18 telemetry) as the
        tiebreak — so a capped sweep (``limit``) always takes the truly
        cold tail and a name with queued admissions, undrained
        executions, an in-flight hydration, or recent traffic is never
        paused ahead of a colder one.  Names resumed within
        ``PAUSE_EVICTION_HYSTERESIS_S`` are exempt (pause/resume flap
        protection for a rotating hot set)."""
        now = time.time()
        cut = now - idle_s
        hyst = Config.get_float(PC.PAUSE_EVICTION_HYSTERESIS_S)
        scored = []
        with self._state_lock:
            versions = self._np("version")
            stopped = self._np("stopped")
            # prune the hysteresis ledger so it stays bounded by the
            # names that actually resumed recently
            for nm in [
                n for n, t in self._resumed_at.items() if now - t > hyst
            ]:
                del self._resumed_at[nm]
            for name, row in self.names.items():
                if row in self.pending_rows or self.queues.get(row):
                    continue  # queued admissions: definitionally not idle
                if self.pending_exec.get(row) or row in self.hydrating_rows:
                    continue  # undrained work / snapshot would be blank
                if int(stopped[row]):
                    continue  # the delete/upgrade path owns stopping rows
                if self.row_activity[row] >= cut:
                    continue
                t_res = self._resumed_at.get(name)
                if t_res is not None and now - t_res < hyst:
                    continue
                scored.append((
                    float(self.row_activity[row]),
                    int(self._heat_host[row]),
                    name, int(versions[row]),
                ))
        scored.sort(key=lambda s: (s[0], s[1]))
        if limit is not None:
            scored = scored[: max(0, int(limit))]
        return [(name, ep) for _t, _h, name, ep in scored]

    def residency_stats(self) -> Dict:
        """The ``stats`` admin op's ``residency`` block: where every name
        lives (engine rows vs paused-in-RAM vs paused-on-disk) plus the
        spill store's internals — and the gauge refresh for the
        ``paused_in_memory`` / ``paused_on_disk`` metrics (stats-cadence,
        like the group-heat pull)."""
        with self._state_lock:
            paused = self.paused
            in_mem = int(getattr(paused, "n_in_memory", len(paused)))
            on_disk = int(getattr(paused, "n_on_disk", 0))
            out = {
                "active_names": len(self.names),
                "pending_rows": len(self.pending_rows),
                "paused_names": len(paused),
                "paused_in_memory": in_mem,
                "paused_on_disk": on_disk,
                "hysteresis_tracked": len(self._resumed_at),
                "store": (
                    paused.stats() if hasattr(paused, "stats")
                    else {"kind": "dict", "in_memory": in_mem, "on_disk": 0}
                ),
            }
        self.metrics.gauge("paused_in_memory", in_mem)
        self.metrics.gauge("paused_on_disk", on_disk)
        return out

    def get_replica_group(self, name: str) -> Optional[List[int]]:
        row = self.names.get(name)
        if row is None:
            return None
        mask = int(self._np("member_mask")[row])
        return [r for r in range(32) if (mask >> r) & 1]

    def epoch_row(self, name: str, epoch: int) -> Optional[int]:
        """Row hosting (name, epoch) here — current or demoted — or None."""
        with self._state_lock:
            row = self.old_epochs.get((name, epoch))
            if row is not None:
                return row
            cur = self.names.get(name)
            if cur is not None and int(self._np("version")[cur]) == epoch:
                return cur
            return None

    def current_epoch(self, name: str) -> Optional[int]:
        with self._state_lock:
            row = self.names.get(name)
            if row is None:
                return None
            return int(self._np("version")[row])

    def is_stopped(self, name: str) -> bool:
        with self._state_lock:
            row = self.names.get(name)
            if row is None:
                return False
            return bool(int(self._np("stopped")[row]))

    def app_caught_up(self, name: str) -> bool:
        """Host app cursor == device frontier for the name's current row:
        the app state string reflects EVERY decision the device has
        executed.  The device can run ahead (host execution is
        payload-gated), so any caller about to serve ``app.checkpoint``
        as a consistent snapshot must check this — a device-level
        ``stopped`` flag alone does NOT mean the app has applied the
        epoch's tail (chaos-sweep find: a truncated 'final state' served
        from a stopped-on-device/lagging-on-host member diverged the
        next epoch's joiners)."""
        with self._state_lock:
            row = self.names.get(name)
            if row is None or row in self.hydrating_rows:
                # un-hydrated (recovery plane): the app state string does
                # not reflect ANY executed decision yet — serving it as a
                # consistent snapshot would hand out the pre-restore blank
                return False
            return int(self.app_exec_slot[row]) == int(
                self._np("exec_slot")[row]
            )

    # ------------------------------------------------------------------
    # cross-node trace plumbing (obs/reqtrace.py)
    # ------------------------------------------------------------------
    def _install_trace_locked(
        self, request_id: int, tc, gossip: bool = True
    ) -> None:
        """Remember a sampled request's trace context (state lock held).
        ``gossip=True`` queues it for the next payloads frame so every
        replica can stamp its decide/execute events; gossip-received
        contexts install with ``gossip=False`` (re-broadcasting them
        would ping-pong; the origin's broadcast already reached all
        peers)."""
        if tc is None or request_id is None:
            return
        d = self.trace_ctx
        if request_id not in d and len(d) >= self.TRACE_CTX_CAP:
            # bounded FIFO: dict preserves insertion order
            for k in list(
                itertools.islice(d, max(1, self.TRACE_CTX_CAP // 8))
            ):
                del d[k]
        d.setdefault(request_id, tc)
        if gossip:
            self._tc_gossip[request_id] = d[request_id]

    @staticmethod
    def _tc_detail(tc) -> Dict:
        """Event-detail fields for a trace context (empty when None)."""
        return {} if tc is None else {"tid": tc[0], "hop": tc[2]}

    # ------------------------------------------------------------------
    # propose (PaxosManager.propose/proposeStop, :1195-1390)
    # ------------------------------------------------------------------
    def propose(
        self,
        name: str,
        request_value: str,
        callback: Optional[Callable] = None,
        stop: bool = False,
        request_id: Optional[int] = None,
        entry_replica: Optional[int] = None,
        trace_ctx=None,
    ) -> Optional[int]:
        """Enqueue a request for consensus; returns the assigned vid (or
        None if the name is unknown here).  ``trace_ctx`` is the optional
        cross-node ``(trace_id, origin, hop)`` a sampled request arrived
        with — installed for the decide/execute/flush hops and recorded
        even when the local tracer is off (sampling is decided at the
        origin).

        Thread-safe: callable from transport threads concurrently with the
        tick loop (the lock covers the vid counter and the queue/arena
        handoff — vids key the cross-replica payload arena, so two threads
        must never mint the same vid for different requests).  User
        callbacks never run under the lock (a blocking callback must not
        stall the tick loop or other transport threads)."""
        cached_hit = False
        cached_response = None
        emulated = None
        with self._state_lock:
            row = self.names.get(name)
            if row is None:
                return None
            entry = self.my_id if entry_replica is None else entry_replica
            # exactly-once fast path: a retransmitted request id is answered
            # from the response cache, not re-proposed
            if request_id is not None and request_id in self.response_cache:
                cached_hit = True
                cached_response = self.response_cache[request_id][1]
            elif (
                request_id is not None
                and self.inflight.get(request_id) in self.vid_meta
            ):
                # original proposal still live here: refresh the callback
                # (the client re-registered) and wait for execution
                if callback is not None:
                    self.outstanding.put(request_id, callback)
                return None
            elif (
                self.emulate_unreplicated or self.lazy_propagation
            ) and not stop:
                # EMULATE_UNREPLICATED / LAZY_PROPAGATION test modes
                # (PaxosManager.java:1731-1778): execute at the entry
                # replica IMMEDIATELY, without waiting for agreement, so a
                # capacity run can attribute cost between app+wire and
                # consensus.  UNREPLICATED skips consensus entirely;
                # LAZY additionally still drives the proposal through the
                # group (peers execute it; the entry's early execution is
                # skipped at commit via the response cache) — both
                # deliberately weaken RSM ordering and exist only for
                # measurement.  The app call runs OUTSIDE the lock below
                # (a slow/failing execute must not wedge the whole node);
                # a concurrent retransmit while it runs is simply dropped
                # (the client retries into the cache).
                if request_id in self._emulating:
                    return None
                if self._next_counter > VID_COUNTER_MASK:
                    raise RuntimeError("vid counter space exhausted")
                counter = self._next_counter
                self._next_counter += 1
                if request_id is None:
                    request_id = (self._rid_nonce << 24) | counter
                self._emulating.add(request_id)
                emulated = (counter, request_id)
            else:
                if self._next_counter > VID_COUNTER_MASK:
                    raise RuntimeError("vid counter space exhausted")
                vid = (self.my_id << VID_NODE_SHIFT) | self._next_counter
                self._next_counter += 1
                if request_id is None:
                    # boot-unique: the bare vid counter RESETS across
                    # restarts when its vid was forwarded away before
                    # being journaled, and a reused id collides with the
                    # now-persistent dedup entries of pre-restart
                    # requests (misread as duplicates — chaos-soak find)
                    request_id = (self._rid_nonce << 24) | (
                        vid & VID_COUNTER_MASK
                    )
                if stop:
                    vid |= STOP_BIT
                self.arena[vid] = request_value
                self.vid_meta[vid] = (entry, request_id)
                # admission scope: queued vids can outlive the instance
                # they were proposed for (row re-homes carry held queues,
                # preemption re-queues by row number) — the drain refuses
                # to admit a vid into a different name's instance, or an
                # epoch-final stop into any later epoch (chaos-soak find:
                # a stale epoch-0 stop decided inside epoch 3 diverges any
                # member whose dedup entry for it aged out)
                self.vid_scope[vid] = (
                    name, int(self._np("version")[row])
                )
                self.inflight[request_id] = vid
                if callback is not None:
                    self.outstanding.put(request_id, callback)
                self.queues.setdefault(row, []).append(vid)
                self.row_activity[row] = time.time()
                self.demand_counts[name] = self.demand_counts.get(name, 0) + 1
                self.demand_backlog += 1
                self._install_trace_locked(request_id, trace_ctx)
                if self.tracer.enabled or trace_ctx is not None:
                    self.tracer.note(
                        request_id, "propose", name=name, node=self.my_id,
                        vid=vid, row=row, entry=entry, stop=bool(stop),
                        force=trace_ctx is not None,
                        **self._tc_detail(trace_ctx),
                    )
        if emulated is not None:
            counter, request_id = emulated
            req = SlimRequest(name, request_id, request_value)
            self._app_execute_retrying(
                req, do_not_reply=(entry != self.my_id)
            )
            response = getattr(req, "response_value", None)
            with self._state_lock:
                if self._cacheable(req):
                    self._cache_response(request_id, response, name)
                self.total_executed += 1
                self.row_activity[row] = time.time()
                self._emulating.discard(request_id)
                if self.lazy_propagation and name in self.names:
                    vid = (self.my_id << VID_NODE_SHIFT) | counter
                    self.arena[vid] = request_value
                    self.vid_meta[vid] = (entry, request_id)
                    self.vid_scope[vid] = (
                        name, int(self._np("version")[row])
                    )
                    self.inflight[request_id] = vid
                    self.queues.setdefault(row, []).append(vid)
            if callback:
                callback(request_id, response)
            return None
        if cached_hit:
            if self.tracer.enabled or trace_ctx is not None:
                self.tracer.note(request_id, "respond-cached", name=name,
                                 node=self.my_id,
                                 force=trace_ctx is not None,
                                 **self._tc_detail(trace_ctx))
            if callback:
                callback(request_id, cached_response)
            return None
        return vid

    def propose_stop(self, name: str, request_value: str = "", **kw) -> Optional[int]:
        return self.propose(name, request_value, stop=True, **kw)

    def propose_batch(
        self,
        items: List[Tuple],
        entry_replica: Optional[int] = None,
    ) -> List[Tuple[Optional[int], str, Optional[str]]]:
        """Batched ingress for a ``client_request_batch`` frame — the
        proposeBatched analog (``PaxosManager.java:1226``) on the entry
        side: ONE lock acquisition, one timestamp, and the per-item work
        stripped to the queue handoff, where the singleton `propose` pays
        lock+clock+cache-churn per request (at 20k req/s the per-request
        constant IS the system capacity).

        ``items``: [(name, value, request_id, callback)] — an optional
        5th element overrides the entry replica per item (forwarded
        proposals keep their original entry) and an optional 6th element
        is the item's cross-node trace context (tid, origin, hop).
        Returns
        [(request_id, outcome, response)]: "queued", "cached" (callback
        already fired with the response), "inflight" (original still
        live; callback re-registered), or "unknown" (name not here).
        Emulation modes take the singleton path (they execute inline)."""
        if self.emulate_unreplicated or self.lazy_propagation:
            # singleton path per item (it executes inline); propose()
            # returns None for BOTH "executed emulated" and "unknown
            # name", so unknown is detected up front — the batch caller
            # owes the client an error response for those
            out = []
            for item in items:
                name, value, rid, cb = item[:4]
                if self.names.get(name) is None:
                    out.append((rid, "unknown", None))
                    continue
                self.propose(
                    name, value, callback=cb, request_id=rid,
                    entry_replica=(
                        item[4] if len(item) > 4 else None
                    ),
                )
                out.append((rid, "emulated", None))
            return out
        results: List[Tuple[Optional[int], str, Optional[str]]] = []
        fired: List[Tuple[Callable, int, Optional[str]]] = []
        now = time.time()
        default_entry = self.my_id if entry_replica is None else entry_replica
        tr_on = self.tracer.enabled
        with self._state_lock:
            versions = self._np("version")
            names, cache = self.names, self.response_cache
            inflight, meta = self.inflight, self.vid_meta
            for item in items:
                name, value, rid, cb = item[:4]
                entry = (
                    item[4] if len(item) > 4 and item[4] is not None
                    else default_entry
                )
                tc = item[5] if len(item) > 5 else None
                row = names.get(name)
                if row is None:
                    results.append((rid, "unknown", None))
                    continue
                if rid is not None and rid in cache:
                    resp = cache[rid][1]
                    if cb is not None:
                        fired.append((cb, rid, resp))
                    results.append((rid, "cached", resp))
                    continue
                if rid is not None and inflight.get(rid) in meta:
                    if cb is not None:
                        self.outstanding.put(rid, cb)
                    results.append((rid, "inflight", None))
                    continue
                if self._next_counter > VID_COUNTER_MASK:
                    # per-item failure, NOT a raise: a mid-frame exception
                    # would discard the already-collected cached responses
                    # in `results` and never fire the callbacks queued in
                    # `fired` — and an up-front whole-frame reject would
                    # deny cached/inflight items that mint no vid at all
                    results.append((rid, "exhausted", None))
                    continue
                vid = (self.my_id << VID_NODE_SHIFT) | self._next_counter
                self._next_counter += 1
                if rid is None:
                    rid = (self._rid_nonce << 24) | (vid & VID_COUNTER_MASK)
                self.arena[vid] = value
                meta[vid] = (entry, rid)
                self.vid_scope[vid] = (name, int(versions[row]))
                inflight[rid] = vid
                if cb is not None:
                    self.outstanding.put_at(rid, cb, now)
                self.queues.setdefault(row, []).append(vid)
                self.row_activity[row] = now
                self.demand_counts[name] = self.demand_counts.get(name, 0) + 1
                self.demand_backlog += 1
                results.append((rid, "queued", None))
                self._install_trace_locked(rid, tc)
                if tr_on or tc is not None:
                    self.tracer.note(
                        rid, "propose", name=name, node=self.my_id,
                        vid=vid, row=row, entry=entry, batch=True,
                        force=tc is not None, **self._tc_detail(tc),
                    )
        for cb, rid, resp in fired:
            cb(rid, resp)
        return results

    def overloaded(self) -> bool:
        """Entry back-pressure: too many in-flight requests here."""
        return len(self.inflight) >= self.max_outstanding

    def has_backlog(self) -> bool:
        """Unadmitted or undecided work exists (drives the server loop's
        adaptive cadence).  Lock-free heuristic peek: a stale read only
        costs one tick of the wrong cadence.  Queues held on PENDING rows
        don't count — they cannot drain until the epoch commit lands, and
        counting them would spin the loop through thousands of no-op
        engine ticks for the whole pending window."""
        hydrating = self.hydrating_rows
        if self.pending_exec and any(
            g not in hydrating for g in self.pending_exec
        ):
            return True
        pending = self.pending_rows
        return any(
            vids and row not in pending and row not in hydrating
            for row, vids in self.queues.items()
        )

    def engine_work_in_flight(self) -> bool:
        """True while any member row holds consensus work that the next
        peer blob can advance: accepted-but-unexecuted lanes or
        outstanding coordinator proposals.  Drives the server's
        event-kicked tick (a blob arriving mid-round should be consumed
        NOW, not a full tick quantum later — per-hop quantum delays are
        what made the socket path's round trip ~10x the engine's)."""
        with self._state_lock:
            acc_slot = self._np("acc_slot")
            acc_vid = self._np("acc_vid")
            exec_slot = self._np("exec_slot")
            prop = self._np("c_prop_vid")
        live = (
            (acc_slot != NULL) & (acc_vid != NULL)
            & (acc_slot >= exec_slot[:, None])
        )
        return bool(live.any() or (prop != NULL).any())

    # ------------------------------------------------------------------
    # host channel ingress (payload replication + forwarded proposals)
    # ------------------------------------------------------------------
    def on_host_message(self, kind: str, body: Dict) -> None:
        with self._state_lock:
            self._on_host_message_locked(kind, body)

    def _on_host_message_locked(self, kind: str, body: Dict) -> None:
        if kind == "payloads":
            fresh: Dict[int, str] = {}
            for k, v in body["arena"].items():
                k = int(k)
                if k not in self.arena:
                    self.arena[k] = v
                    fresh[k] = v
            for k, meta in body.get("meta", {}).items():
                self.vid_meta.setdefault(int(k), (meta[0], meta[1]))
            if fresh and self.logger is not None:
                # peer-replicated payloads must be durable HERE too: if
                # only the admitting coordinator persisted them, a
                # coordinator-only crash could lose decided-but-unexecuted
                # values for everyone
                t_lp = time.monotonic()
                self.logger.log_payloads(fresh, meta={
                    k: self.vid_meta[k] for k in fresh if k in self.vid_meta
                })
                DelayProfiler.update_count(
                    "t_log_payloads", time.monotonic() - t_lp
                )
            tcs = body.get("tc")
            if tcs:
                # trace contexts ride the payload gossip so every replica
                # can stamp its decide/execute events with the trace id
                # (gossip=False: the origin already broadcast to all)
                for rid_s, tc in tcs.items():
                    try:
                        self._install_trace_locked(
                            int(rid_s),
                            (int(tc[0]), int(tc[1]), int(tc[2])),
                            gossip=False,
                        )
                    except (TypeError, ValueError, IndexError):
                        continue
            ae = body.get("app_exec")
            if ae is not None:
                rid, cursors = ae
                arr = self.peer_app_exec.get(rid)
                if arr is None:
                    arr = np.zeros(self.cfg.n_groups, np.int64)
                    self.peer_app_exec[rid] = arr
                if isinstance(cursors, dict):  # sparse delta (normal path)
                    # LAST-writer-wins for rows the sender lists: it is
                    # authoritative for its own cursor, frames are FIFO
                    # per peer, and a max-only merge could never LOWER a
                    # stale value left by a row's previous tenant (which
                    # would pin the retention watermark wrongly and
                    # false-arm the frontier-stall detector forever)
                    for row_s, cur in cursors.items():
                        arr[int(row_s)] = cur
                else:  # dense snapshot (legacy peers)
                    np.maximum(arr, np.asarray(cursors, np.int64), out=arr)
        elif kind == "forward":  # a peer forwards a proposal to me
            fwd_epoch = body.get("epoch")
            if fwd_epoch is not None and (
                self.current_epoch(body["name"]) != int(fwd_epoch)
            ):
                # a DELAYED forward from a superseded epoch must not be
                # injected into the current one — an old epoch's stop
                # executing in the new epoch diverges the RSM (chaos
                # soak); genuine client requests retransmit
                return
            tc = body.get("tc")
            tc = None if not tc else (int(tc[0]), int(tc[1]), int(tc[2]))
            if self.tracer.enabled or tc is not None:
                self.tracer.note(
                    body.get("request_id"), "forward-in",
                    name=body["name"], node=self.my_id,
                    entry=body.get("entry"),
                    force=tc is not None, **self._tc_detail(tc),
                )
            self.propose(
                body["name"], body["value"],
                stop=body.get("stop", False),
                request_id=body.get("request_id"),
                entry_replica=body.get("entry", None),
                trace_ctx=tc,
            )
        elif kind == "forward_batch":
            # a peer forwards a whole queue run (one frame, many
            # proposals).  Same staleness guard as singleton forwards.
            # FIFO within the run is preserved: requests accumulated
            # before a stop flush BEFORE the stop is proposed (proposing
            # the stop first would decide it ahead of requests that
            # preceded it, and the epoch bump would drop them as stale).
            if self.current_epoch(body["name"]) != int(body["epoch"]):
                return
            name = body["name"]
            tcs = body.get("tc") or {}

            def _tc_of(rid):
                tc = tcs.get(str(rid))
                return None if not tc else (
                    int(tc[0]), int(tc[1]), int(tc[2])
                )

            tr_on = self.tracer.enabled
            if tr_on or tcs:
                for rid, entry, _v, _s in body["reqs"]:
                    tc = _tc_of(rid)
                    if tr_on or tc is not None:
                        self.tracer.note(rid, "forward-in", name=name,
                                         node=self.my_id, entry=entry,
                                         force=tc is not None,
                                         **self._tc_detail(tc))
            items = []
            for rid, entry, value, stop in body["reqs"]:
                if stop:
                    if items:
                        self.propose_batch(items)
                        items = []
                    self.propose(
                        name, value, stop=True, request_id=rid,
                        entry_replica=entry, trace_ctx=_tc_of(rid),
                    )
                else:
                    items.append((name, value, rid, None, entry,
                                  _tc_of(rid)))
            if items:
                self.propose_batch(items)
        elif kind == "state_request":  # checkpoint-transfer pull
            self._serve_state_request(body)
        elif kind == "state_reply":
            self._apply_state_reply(
                body["states"], body.get("response_cache") or {}
            )
        elif kind == "need_payloads":  # straggler pull (SYNC_DECISIONS)
            sync = SyncDecisionsPacket.from_json(body)
            have = {v: self.arena[v] for v in sync.missing if v in self.arena}
            if have:
                meta = {
                    v: list(self.vid_meta[v])
                    for v in have if v in self.vid_meta
                }
                self.forward_out.append(
                    (sync.node_id, "payloads", {"arena": have, "meta": meta})
                )

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------
    def coordinator_of_row(self, row: int) -> int:
        return int(ballot_coord(int(self._np("bal")[row])))

    def _filter_stale_vids(self, row: int, vids: List[int]) -> List[int]:
        """Admission guard: drop queued vids whose proposal scope no
        longer matches the instance now living at this row.  A vid may
        ride a re-home, a pause record, or a preemption re-queue into a
        row that has since been reused by another name, or into a later
        epoch of the same name.  Ordinary requests legitimately cross
        epochs (the app state carries over; exactly-once holds via the
        dedup cache) — but an epoch-final STOP is epoch-specific: decided
        in a later epoch it wrongly stops that epoch, and any member
        whose dedup entry for it expired executes it (RSM divergence,
        chaos-soak find).  Cross-NAME vids are always dropped.  Dropped
        vids release their inflight slot so a retransmitted proposal
        (e.g. the stop task's re-drive, which uses a deterministic
        request id) is not deduped against the dead one."""
        name = self.row_name.get(row)
        epoch_now = int(self._np("version")[row])
        keep: List[int] = []
        for vid in vids:
            if vid in self.retained:
                # a preemption re-queue raced the decision: the original
                # proposal got decided (and executed) after the re-queue,
                # so this copy is done — drop it from the queue WITHOUT
                # touching arena/meta (retention GC owns that lifecycle;
                # peers may still pull the payload)
                continue
            scope = self.vid_scope.get(vid)
            stale = scope is not None and (
                scope[0] != name
                or (bool(vid & STOP_BIT) and scope[1] != epoch_now)
            )
            if not stale and vid in self.arena:
                keep.append(vid)
                continue
            # out-of-scope, or the payload is gone (decided elsewhere and
            # retention-GC'd): nothing valid to propose — admitting it
            # would decide a lost payload, and forwarding it would ship
            # an EMPTY value that wedges the peer's RSM (chaos-soak find)
            self._release_vid(vid)
        # ALWAYS install and return the live queue list: callers mutate the
        # returned list in place (the forward branch clears it) and must be
        # operating on the real queue, not a filtered copy
        self.queues[row] = keep
        return keep

    def _coalesce_row_queue(self, row: int, name: str, epoch: int,
                            vids: List[int]) -> List[int]:
        """Pack runs of plain requests into BATCH vids (the RequestBatcher
        analog, ``RequestBatcher.java:40-158``): one consensus value then
        decides up to MAX_BATCH_SIZE client requests.  FIFO order is
        preserved; stops and already-minted batches pass through as their
        own lanes.  Mutates scheduling tables: member vids' arena/meta/
        scope move under the batch vid and their request ids repoint to it
        so the in-flight propose dedup keeps gating retransmits."""
        out: List[int] = []
        chunk: List[int] = []

        def flush() -> None:
            if len(chunk) == 1:
                out.append(chunk[0])
            elif chunk:
                subs = []
                for v in chunk:
                    entry, rid = self.vid_meta.get(v, (self.my_id, v))
                    subs.append((rid, entry, self.arena[v]))
                if self._next_counter > VID_COUNTER_MASK:
                    raise RuntimeError("vid counter space exhausted")
                bvid = (
                    BATCH_BIT
                    | (self.my_id << VID_NODE_SHIFT)
                    | self._next_counter
                )
                self._next_counter += 1
                self.arena[bvid] = encode_batch(subs)
                # batch vids carry no single request id: -1 is outside
                # every id namespace, so nothing ever dedups against it
                self.vid_meta[bvid] = (self.my_id, -1)
                self.vid_scope[bvid] = (name, epoch)
                for v in chunk:
                    self.arena.pop(v, None)
                    _e, rid = self.vid_meta.pop(v, (None, None))
                    self.vid_scope.pop(v, None)
                    if rid is not None and self.inflight.get(rid) == v:
                        self.inflight[rid] = bvid
                out.append(bvid)
            chunk.clear()

        for v in vids:
            if (v & (STOP_BIT | BATCH_BIT)) == 0:
                chunk.append(v)
                if len(chunk) >= self.max_batch_size:
                    flush()
            else:
                flush()
                out.append(v)
        flush()
        return out

    def build_requests(self) -> np.ndarray:
        """Single-step [G, K] lanes (the n_steps=1 face of the ring)."""
        return self.build_request_ring(1)[0]

    def build_request_ring(self, n_steps: int) -> np.ndarray:
        """Drain queues into the [n_steps, G, K] device request ring —
        slab i feeds dispatch substep i, so one host admission pass
        covers N engine steps; forward non-coordinated groups' requests
        to their believed coordinator.  Records the staged vid count for
        the ``device_queue_depth`` gauge."""
        G, K = self.cfg.n_groups, self.cfg.req_lanes
        depth = K * n_steps
        req = np.full((n_steps, G, K), NULL, np.int32)
        staged = 0
        bal = self._np("bal")
        for row, vids in list(self.queues.items()):
            if not vids:
                continue
            if row in self.pending_rows:
                # pre-COMPLETE epoch: hold (don't admit, don't forward) —
                # nothing may commit on a row the reconfigurator's probe
                # may still move; the queue drains once epoch_commit lands
                continue
            if row in self.hydrating_rows:
                # un-hydrated name with live traffic: hold admission and
                # promote it to the front of the hydration queue — the
                # held requests drain the moment its app state lands
                if self.hydrator is not None:
                    name = self.row_name.get(row)
                    if name is not None:
                        self.hydrator.request(name)
                continue
            vids = self._filter_stale_vids(row, vids)
            if not vids:
                continue
            coord = int(ballot_coord(int(bal[row])))
            if coord != self.my_id:
                name = self.row_name.get(row)
                if name is None:
                    vids.clear()
                    continue
                epoch_now = int(self._np("version")[row])
                # ONE forward_batch frame per row per tick (at capacity a
                # per-request forward frame was one json encode + syscall
                # + decode + singleton propose EACH — the non-coordinator
                # entry's whole budget); the coordinator re-proposes the
                # list under one lock acquisition
                reqs = []
                for vid in vids:
                    # _filter_stale_vids (just above, same lock) guarantees
                    # every kept vid has its payload in the arena
                    if vid & BATCH_BIT:
                        # a preemption re-queued this batch onto a row we
                        # no longer coordinate: unbundle and forward the
                        # members — the new coordinator re-coalesces them
                        # under its own vid space
                        for rid, entry, value in decode_batch(self.arena[vid]):
                            reqs.append([rid, entry, value, False])
                    else:
                        entry, rid = self.vid_meta.get(vid, (self.my_id, vid))
                        reqs.append(
                            [rid, entry, self.arena[vid],
                             bool(vid & STOP_BIT)]
                        )
                    # the coordinator re-mints its own vid; our local copy
                    # would only go stale (the callback stays in
                    # self.outstanding keyed by request_id)
                    self.arena.pop(vid, None)
                    self.vid_meta.pop(vid, None)
                    self.vid_scope.pop(vid, None)
                if reqs:
                    # traced requests carry their context to the
                    # coordinator, hop-incremented (one process boundary)
                    fwd_tc = {}
                    tcm = self.trace_ctx
                    for rid, _e, _v, _s in reqs:
                        tc = tcm.get(rid) if tcm else None
                        if tc is not None:
                            fwd_tc[str(rid)] = [tc[0], tc[1], tc[2] + 1]
                        if self.tracer.enabled or tc is not None:
                            self.tracer.note(
                                rid, "forward-out", name=name,
                                node=self.my_id, to=coord,
                                force=tc is not None,
                                **self._tc_detail(tc),
                            )
                    body = {
                        "name": name, "epoch": epoch_now, "reqs": reqs,
                    }
                    if fwd_tc:
                        body["tc"] = fwd_tc
                    self.forward_out.append(
                        (coord, "forward_batch", body)
                    )
                vids.clear()
                continue
            if self.batching_enabled and len(vids) > max(
                depth, self.min_batch_trigger - 1
            ):
                name = self.row_name.get(row)
                if name is not None:
                    vids = self.queues[row] = self._coalesce_row_queue(
                        row, name, int(self._np("version")[row]), vids
                    )
            take = vids[:depth]
            for off in range(0, len(take), K):
                slab = take[off:off + K]
                req[off // K, row, : len(slab)] = slab
            staged += len(take)
        self._last_ring_depth = staged
        return req

    def tick(
        self,
        gathered: Blob,
        heard: np.ndarray,
        want_coord: Optional[np.ndarray] = None,
    ) -> Tuple[Blob, Dict]:
        """One full cycle; returns (my fresh blob, host-channel delta).

        Holds the manager lock for the whole cycle: the transport-thread
        entry points (propose / on_host_message / create / kill) mutate
        the same queues, arena, and vid tables this reads and rewrites.
        User callbacks collected during execution fire AFTER the lock is
        released (a blocking callback must not wedge transport threads)."""
        with self._state_lock:
            result = self._tick_locked(gathered, heard, want_coord)
            fired, self._fired_callbacks = self._fired_callbacks, []
        for cb, rid, resp in fired:
            cb(rid, resp)
        return result

    def tick_host(
        self,
        gathered_vec: np.ndarray,
        heard: np.ndarray,
        want_coord: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, "EngineState", Dict]:
        """Packed-I/O tick for the deployed socket runtime: `gathered_vec`
        is the [R, N] stack of packed peer blob vectors (== the `D` wire
        frame bodies); returns (my fresh packed blob vector, the state it
        reflects — for identity-based staleness checks, captured under
        the lock so lifecycle ops can't mispair them — and the host
        delta).  One device upload + two downloads per tick instead of
        ~50 per-leaf dispatches — at loopback scale the per-leaf dispatch
        overhead was most of a node's tick cost."""
        with self._state_lock:
            result = self._tick_host_locked(gathered_vec, heard, want_coord)
            fired, self._fired_callbacks = self._fired_callbacks, []
        for cb, rid, resp in fired:
            cb(rid, resp)
        return result

    # ------------------------------------------------------------------
    # double-buffered dispatch (the serving pipeline's step entry):
    # step_dispatch admits batch N and fires the jitted step WITHOUT
    # waiting for the device; the caller then does host-side codec /
    # publish work while the ~1ms step runs, and step_complete syncs +
    # runs the post-step host cycle.  Transport threads frame, decode,
    # and admit batch N+1 throughout (the lock is free during the sync).
    # Step-for-step state-identical to tick_host (tests/test_pipeline.py).
    # ------------------------------------------------------------------
    def _await_step_locked(self) -> None:
        """Wait (lock held; CV releases it) until no step is in flight.
        Called at the TOP of every op that replaces engine state or
        depends on post-step bookkeeping — such ops must observe a fully
        completed tick, exactly as under the serial path.

        No-op for the thread that OWNS the in-flight step: by the time
        it runs post-step host work (checkpoint cadence, stop hooks) the
        device sync already happened, so it always sees complete state —
        and waiting would deadlock it on its own completion (the durable
        probe found exactly that: the first checkpoint-cadence fire
        inside step_complete wedged the node)."""
        while self._step_inflight and \
                self._step_thread != threading.get_ident():
            self._step_cv.wait()

    def step_dispatch(
        self,
        gathered_vec: np.ndarray,
        heard: np.ndarray,
        want_coord: Optional[np.ndarray] = None,
    ) -> Dict:
        """Admit + dispatch one engine step; returns the pending handle
        for :meth:`step_complete`.  The returned device values are NOT
        synced — self.state already points at the in-flight result (any
        reader that np.asarray's it simply blocks until the device is
        done, which is correct but serializing; the hot propose path
        avoids that via the carried lifecycle-leaf cache below)."""
        with self._state_lock:
            self._await_step_locked()  # single-depth pipeline
            cfg = self.cfg
            G = cfg.n_groups
            req = self.build_request_ring(self.steps_per_dispatch)
            wc = (
                np.zeros((G,), bool) if want_coord is None
                else np.asarray(want_coord, bool)
            )
            old_state = self.state
            # Carry the lifecycle-owned leaves' host cache across the
            # swap: the step passes version/member_mask/majority/tag
            # through UNCHANGED (ops/engine.py keeps them), and the
            # transport-thread propose/admission path reads them during
            # the overlap window — a cache miss there would block on the
            # device sync and re-serialize exactly what the pipeline
            # exists to overlap.  Copies are taken BEFORE the jit call:
            # the step donates old_state's buffers.
            carry: Dict[str, np.ndarray] = {}
            if self._np_cache_state is old_state:
                for leaf in ("version", "member_mask", "majority", "tag"):
                    arr = self._np_cache.get(leaf)
                    if arr is not None:
                        carry[leaf] = arr
            for leaf in ("version", "member_mask"):
                if leaf not in carry:
                    carry[leaf] = to_host(getattr(old_state, leaf))
            t0 = time.monotonic()
            dev = self.device
            new_state, out_vec, blob_vec, new_heat = self._dispatch_step(
                old_state, _dev(gathered_vec, torch.int32, dev),
                _dev(heard, torch.bool, dev), _dev(req, torch.int32, dev),
                _dev(wc, torch.bool, dev), np.int32(self.my_id),
                self._heat_dev, launch_log=self.kernel_launches,
            )
            self.state = new_state
            self._heat_dev = new_heat
            self._np_cache = carry
            self._np_cache_state = new_state
            self._step_inflight = True
            self._step_thread = threading.get_ident()
            return {
                "out_vec": out_vec, "blob_vec": blob_vec,
                "state": new_state, "t0": t0,
            }

    def step_complete(
        self, pend: Dict
    ) -> Tuple[np.ndarray, "EngineState", Dict]:
        """Sync the in-flight step and run the post-step host cycle;
        returns (packed publish vector, the state it reflects, host
        delta) — the same triple as :meth:`tick_host`."""
        # device sync OUTSIDE the lock: the copy to host blocks with the
        # GIL released, so transport threads run the ingress/codec path
        # against the still-valid carried caches while the device works
        out_np_vec = to_host(pend["out_vec"])
        blob_vec = to_host(pend["blob_vec"])
        t0 = pend["t0"]
        with self._state_lock:
            try:
                DelayProfiler.update_delay("engine_step", t0)
                self.last_engine_step_s = time.monotonic() - t0
                DelayProfiler.update_count(
                    "t_engine_step", self.last_engine_step_s
                )
                outs = [split_out_vec(row, self.cfg) for row in out_np_vec]
                host_delta = self._post_step_locked(outs)
            finally:
                self._step_inflight = False
                self._step_thread = None
                self._step_cv.notify_all()
            fired, self._fired_callbacks = self._fired_callbacks, []
        for cb, rid, resp in fired:
            cb(rid, resp)
        return blob_vec, pend["state"], host_delta

    def _tick_host_locked(
        self,
        gathered_vec: np.ndarray,
        heard: np.ndarray,
        want_coord: Optional[np.ndarray],
    ) -> Tuple[np.ndarray, Dict]:
        self._await_step_locked()
        cfg = self.cfg
        G = cfg.n_groups
        req = self.build_request_ring(self.steps_per_dispatch)
        wc = (
            np.zeros((G,), bool) if want_coord is None
            else np.asarray(want_coord, bool)
        )
        t0 = time.monotonic()
        dev = self.device
        new_state, out_vec, blob_vec, new_heat = self._dispatch_step(
            self.state, _dev(gathered_vec, torch.int32, dev),
            _dev(heard, torch.bool, dev), _dev(req, torch.int32, dev),
            _dev(wc, torch.bool, dev), np.int32(self.my_id),
            self._heat_dev, launch_log=self.kernel_launches,
        )
        self.state = new_state
        self._heat_dev = new_heat
        out_np_vec = to_host(out_vec)  # one transfer; forces the sync
        DelayProfiler.update_delay("engine_step", t0)
        self.last_engine_step_s = time.monotonic() - t0
        DelayProfiler.update_count("t_engine_step", self.last_engine_step_s)
        outs = [split_out_vec(row, cfg) for row in out_np_vec]
        host_delta = self._post_step_locked(outs)
        return to_host(blob_vec), new_state, host_delta

    def _tick_locked(
        self,
        gathered: Blob,
        heard: np.ndarray,
        want_coord: Optional[np.ndarray] = None,
    ) -> Tuple[Blob, Dict]:
        self._await_step_locked()
        cfg = self.cfg
        G = cfg.n_groups
        req = self.build_request_ring(self.steps_per_dispatch)
        wc = (
            np.zeros((G,), bool) if want_coord is None
            else np.asarray(want_coord, bool)
        )
        # the Blob-of-leaves exchange reaches the unified packed step as
        # one [R, NB] matrix (each row == pack_blob of that replica);
        # donate=False — the test-cluster harness caches blob views that
        # alias the live state across ticks
        dev = self.device
        gvec = pack_rows(gathered, dev, launch_log=self.kernel_launches)
        t0 = time.monotonic()
        new_state, out_vec, blob_vec, new_heat = self._tick_step(
            self.state, gvec, _dev(heard, torch.bool, dev),
            _dev(req, torch.int32, dev), _dev(wc, torch.bool, dev),
            np.int32(self.my_id), self._heat_dev,
            launch_log=self.kernel_launches,
        )
        self.state = new_state
        self._heat_dev = new_heat
        out_np_vec = to_host(out_vec)  # one transfer; forces the sync
        # update_delay takes the START time (it computes monotonic()-t0)
        DelayProfiler.update_delay("engine_step", t0)
        self.last_engine_step_s = time.monotonic() - t0
        DelayProfiler.update_count("t_engine_step", self.last_engine_step_s)

        outs = [split_out_vec(row, cfg) for row in out_np_vec]
        host_delta = self._post_step_locked(outs)
        return split_blob_vec(to_host(blob_vec), cfg), host_delta

    def _post_step_locked(self, outs) -> Dict:
        """Shared post-engine host work (requeue, watermarks, journaling,
        execution, state pulls, gossip delta) for every tick flavor.

        ``outs`` is the dispatch's LIST of per-substep StepOutputs (a
        bare StepOutputs is accepted as a 1-list) — one host cycle per
        dispatch covers all N device-resident substeps: per-substep work
        (decision logging, execution, preempt requeue) runs in substep
        order; per-dispatch work (ballot pull, watermarks, checkpoint
        cadence, gossip delta) runs once against the final state."""
        if isinstance(outs, StepOutputs):
            outs = [outs]
        last = outs[-1]
        n_sub = len(outs)
        self._tick_no += 1
        if any(
            o.n_admitted.any() or o.n_committed.any()
            or o.acc_new.any() or o.bal_new.any()
            for o in outs
        ):
            self.last_progress_tick = self._tick_no
        # re-propose preempted requests at a fresh slot (PREEMPTED
        # analog), in substep order; appended AFTER the ring requeue
        # below so a vid preempted at substep i cannot collide with the
        # slab bookkeeping of substeps > i
        preempt_requeue = []
        for o in outs:
            pre_g, pre_l = np.nonzero(o.preempted_vid != NULL)
            for g_, l_ in zip(pre_g, pre_l):
                vid = int(o.preempted_vid[g_, l_])
                if vid in self.arena and vid not in self.retained:
                    preempt_requeue.append((int(g_), vid))
        # per-step engine metrics: aggregate counters reduced from the
        # vectorized step outputs — a few O(G) numpy sums per DISPATCH
        # (the engine step itself is ~1ms), never per-request host work
        mx = self.metrics
        n_dec = int(sum(int(o.n_committed.sum()) for o in outs))
        if n_dec:
            mx.count("decisions_executed", n_dec)
        n_admit = int(sum(int(o.n_admitted.sum()) for o in outs))
        if n_admit:
            mx.count("requests_admitted", n_admit)
        if preempt_requeue:
            mx.count("preempts", len(preempt_requeue))
        bal_rose = outs[0].bal_new
        for o in outs[1:]:
            bal_rose = bal_rose | o.bal_new
        flips = rises = 0
        if bal_rose.any():
            # coordinator flips: `bal` is only pulled host-side on the
            # rare dispatches where a promised ballot rose (elections),
            # and only the risen rows are compared against the cached
            # view; the pull reflects the dispatch-final state
            pg_m = np.nonzero(bal_rose)[0]
            bal_host = self._np("bal")
            self._bal_host = bal_host.copy()
            new_coord = ballot_coord(bal_host[pg_m]).astype(np.int32)
            flips = int((new_coord != self._coord_cache[pg_m]).sum())
            if flips:
                mx.count("coordinator_flips", flips)
            self._coord_cache[pg_m] = new_coord
            rises = len(pg_m)
            mx.count("ballot_rises", rises)
        mx.gauge("frontier_stall_groups", len(self._payload_blocked))
        mx.gauge("inflight_requests", len(self.inflight))
        mx.gauge("arena_payloads", len(self.arena))
        mx.observe("engine_step_s", self.last_engine_step_s)
        # residency plane: steps amortized per host dispatch, staged
        # device-ring depth, and the per-substep amortized host cost
        mx.count("host_dispatches")
        mx.gauge("dispatch_steps_per_host", n_sub)
        mx.gauge("device_queue_depth", self._last_ring_depth)
        mx.observe(
            "dispatch_amortized_s", self.last_engine_step_s / n_sub
        )
        # retrace sentinel: fold the shared sentinels' totals into this
        # node's counters as deltas (attribute reads only — no device
        # traffic), and mark them warm after the first completed
        # dispatch.  A retrace after warmup is the recompile analog of a
        # stray hot-path _np pull: it still WORKS, ~100x slower — so it
        # is shouted into the log, not just a metric
        n_c = self._dispatch_step.n_compiles + self._tick_step.n_compiles
        n_r = self._dispatch_step.n_retraces + self._tick_step.n_retraces
        if n_c != self._compile_seen:
            mx.count("engine_compiles", n_c - self._compile_seen)
            self._compile_seen = n_c
        if n_r != self._retrace_seen:
            mx.count("engine_retraces", n_r - self._retrace_seen)
            self._retrace_seen = n_r
            self.log.error(
                "engine step RETRACED after warmup (%d total): %s",
                n_r, self._dispatch_step.stats(),
            )
        if not self._dispatch_step.warm:
            self._dispatch_step.mark_warm()
            self._tick_step.mark_warm()
        # flight recorder: the per-step summary ring (always on; skips
        # pure-idle ticks internally so the ring spans real history)
        self.flight.record_step(
            tick=self._tick_no, admitted=n_admit, decided=n_dec,
            preempts=len(preempt_requeue), coordinator_flips=flips,
            ballot_rises=rises,
            frontier_stalls=len(self._payload_blocked),
            inflight=len(self.inflight),
        )
        # payload-retention watermark: min APP-execution cursor over all
        # group members (device frontiers can run ahead of payload-gated
        # app execution — GC'ing on them would strand a parked peer).
        # Peer cursors arrive by host-channel gossip; unheard-from peers
        # hold the watermark down until they gossip (a long-dead member
        # is eventually bypassed via checkpoint transfer, not GC).
        mask = self._np("member_mask")
        R = self.cfg.n_replicas
        rids = np.arange(R)
        in_group = ((mask[None, :] >> rids[:, None]) & 1) == 1
        cursors = np.stack([
            self.peer_app_exec.get(r, self._zero_cursors)
            if r != self.my_id else self.app_exec_slot
            for r in range(R)
        ])
        # A member more than JUMP_HORIZON behind the majority frontier no
        # longer holds the payload-retention watermark down: it can never
        # catch up through the rings and will recover via checkpoint
        # transfer instead (state_request/state_reply below) — without
        # this, one dead member pins every payload forever.
        horizon = last.maj_exec.astype(np.int64) - self.jump_horizon
        eligible = in_group & (cursors >= horizon[None, :])
        cur_masked = np.where(eligible, cursors, np.iinfo(np.int64).max)
        self._min_exec = np.where(
            eligible.any(axis=0), cur_masked.min(axis=0), self._min_exec
        )
        # requeue what wasn't admitted: the ring staged queue slab i into
        # substep i's lanes, and the engine admits a contiguous prefix
        # per slab — admitted = union of slab prefixes, leftovers keep
        # their order ahead of the unstaged tail
        K = self.cfg.req_lanes
        payload_delta: Dict[int, str] = {}
        meta_delta: Dict[int, Tuple[int, int]] = {}
        for row, vids in list(self.queues.items()):
            if not vids:
                continue
            admitted: List[int] = []
            rest: List[int] = []
            for i, o in enumerate(outs):
                slab = vids[i * K:(i + 1) * K]
                na = int(o.n_admitted[row])
                admitted += slab[:na]
                rest += slab[na:]
            rest += vids[n_sub * K:]
            self.queues[row] = rest
            for vid in admitted:
                payload_delta[vid] = self.arena.get(vid, "")
                if vid in self.vid_meta:
                    meta_delta[vid] = self.vid_meta[vid]
        for row, vid in preempt_requeue:
            self.queues.setdefault(row, []).append(vid)

        # log-before-send: persist the promise + accept delta before the
        # blob leaves (bare promises too — a ballot that rose with no
        # accept must survive a crash, ADVICE r1 high / handlePrepare's
        # LogMessagingTask rule).  The whole tick's blocks (including the
        # decision log inside _execute) leave as ONE group commit
        # (BatchedLogger analog) — flushed before this function returns,
        # so log-before-send still holds for the published blob.
        if self.logger is not None:
            with self.logger.batch():
                pg = np.nonzero(bal_rose)[0]
                if len(pg):
                    bal_np = self._np("bal")
                    self.logger.log_promises(pg.astype(np.int32), bal_np[pg])
                # accept lanes changed by ANY substep, valued from the
                # dispatch-final state: a lane overwritten by a LATER
                # substep's accept implies its earlier slot was decided
                # within this dispatch, and that decision is journaled
                # per substep by _execute below — so the final lane view
                # plus the per-substep decision log loses nothing
                acc_any = outs[0].acc_new
                for o in outs[1:]:
                    acc_any = acc_any | o.acc_new
                gs, lanes = np.nonzero(acc_any)
                if len(gs):
                    acc_slot = self._np("acc_slot")
                    acc_bal = self._np("acc_bal")
                    acc_vid = self._np("acc_vid")
                    self.logger.log_accepts(
                        gs.astype(np.int32),
                        acc_slot[gs, lanes],
                        acc_bal[gs, lanes],
                        acc_vid[gs, lanes],
                    )
                if payload_delta:
                    self.logger.log_payloads(payload_delta, meta=meta_delta)
                for o in outs:
                    self._execute(o)
        else:
            for o in outs:
                self._execute(o)
        self._maybe_request_state(last)
        self.outstanding.gc()
        if self._tick_no % 64 == 0 and self.inflight:
            # entries whose vid left vid_meta (forwarded to a coordinator /
            # GC'd) no longer gate re-proposal
            self.inflight = {
                r: v for r, v in self.inflight.items() if v in self.vid_meta
            }
        self._maybe_checkpoint(last)

        # periodic full-baseline refresh: a dropped gossip frame must not
        # strand peers' cursor views forever (the sparse delta has no
        # pull/heal path of its own) — O(live groups), not O(G)
        if self._tick_no % 256 == 0:
            self._app_exec_dirty.update(self.names.values())
            self._app_exec_dirty.update(self.old_epochs.values())
        dirty, self._app_exec_dirty = self._app_exec_dirty, set()
        host_delta = {
            "arena": payload_delta,
            "meta": {k: list(v) for k, v in meta_delta.items()},
            "app_exec": (self.my_id, {
                int(g): int(self.app_exec_slot[g]) for g in dirty
            }),
        }
        if self._tc_gossip:
            # sampled requests' trace contexts ride the payloads frame
            # once (drain): peers stamp their decide/execute events with
            # the shared trace id
            tc_out, self._tc_gossip = self._tc_gossip, {}
            host_delta["tc"] = {
                str(rid): list(tc) for rid, tc in tc_out.items()
            }
        return host_delta

    # ------------------------------------------------------------------
    # execution (EEC analog, PaxosInstanceStateMachine.java:1511-1734)
    # ------------------------------------------------------------------
    def _execute(self, out_np) -> None:
        committed = np.nonzero(out_np.n_committed)[0]
        if self.logger is not None and len(committed):
            t_j = time.monotonic()
            rows, slots, vids = [], [], []
            for g in committed:
                base = int(out_np.exec_base[g])
                for o in range(int(out_np.n_committed[g])):
                    rows.append(g)
                    slots.append(base + o)
                    vids.append(int(out_np.exec_vid[g, o]))
            self.logger.log_decisions(
                np.array(rows, np.int32), np.array(slots, np.int32),
                np.array(vids, np.int32),
            )
            DelayProfiler.update_count("t_journal", time.monotonic() - t_j)
        if len(committed):
            self.row_activity[committed] = time.time()
        tr = self.tracer
        tcm = self.trace_ctx
        # ballot attribution for decide events + the flight recorder's
        # decided ring comes from the rise-tick host view (_bal_host) —
        # pulling `bal` from the device per commit tick costs a sync
        # that measurably perturbs soak timing
        bal_np = self._bal_host
        for g in committed:
            base = int(out_np.exec_base[g])
            bal_g = int(bal_np[g])
            pend = self.pending_exec.setdefault(int(g), {})
            for o in range(int(out_np.n_committed[g])):
                vid = int(out_np.exec_vid[g, o])
                pend[base + o] = vid
                self.flight.record_decided(int(g), base + o, bal_g, vid)
                if vid == 0:
                    continue
                meta = self.vid_meta.get(vid)
                key = vid if meta is None or meta[1] == -1 else meta[1]
                tc = tcm.get(key) if tcm else None
                if tr.enabled or tc is not None:
                    tr.note(
                        key, "decide", name=self.row_name.get(int(g)),
                        node=self.my_id, row=int(g), slot=base + o,
                        vid=vid, ballot=bal_g,
                        force=tc is not None, **self._tc_detail(tc),
                    )
        t_exec = time.monotonic()
        missing = self._drain_pending_exec()
        DelayProfiler.update_delay("app_execute", t_exec)
        dt_exec = time.monotonic() - t_exec
        DelayProfiler.update_count("t_app_execute", dt_exec)
        if len(committed):
            # per-phase latency distribution (SLO surface): the decided-
            # slot execution leg of a tick, exported via /metrics + stats
            self.metrics.observe("phase_execute_s", dt_exec)
        if missing:
            self.forward_out.append(
                (-1, "need_payloads", SyncDecisionsPacket(
                    node_id=self.my_id, missing=missing,
                    is_missing_too_much=len(missing) > self.sync_threshold,
                ).to_json())
            )
        # retention GC: drop payloads every live member has executed past
        if self._tick_no % 32 == 0 and self.retained:
            for vid, (g, slot) in list(self.retained.items()):
                if slot < self._min_exec[g]:
                    del self.retained[vid]
                    self.arena.pop(vid, None)
                    self.vid_meta.pop(vid, None)
                    self.vid_scope.pop(vid, None)

    def _drain_pending_exec(self) -> List[int]:
        """Execute decided slots in order through the app, payload-gated;
        returns vids whose payloads are missing (to pull from peers)."""
        missing: List[int] = []
        for g in list(self.pending_exec.keys()):
            if g in self.hydrating_rows:
                # recovery plane: executing decided slots against the
                # not-yet-restored app state would diverge the RSM —
                # park until the hydrator restores this row, then the
                # next drain (the hydrator runs one itself) catches up
                if self.hydrator is not None:
                    name = self.row_name.get(g)
                    if name is not None:
                        self.hydrator.request(name)
                continue
            if g in self._needs_state:
                # blank join awaiting a donor's app state (commit-heal
                # resumed this member before its epoch-final-state fetch
                # landed): executing decided slots against the EMPTY
                # state would emit wrong responses/entry callbacks that
                # the later state adoption cannot retract — park until
                # the needs_state pull (fired every tick by
                # _maybe_request_state) delivers the state
                continue
            pend = self.pending_exec[g]
            name = self.row_name.get(g)
            cursor = int(self.app_exec_slot[g])
            blocked = False
            while cursor in pend:
                vid = pend[cursor]
                if not self._execute_one(name, g, cursor, vid):
                    missing.append(vid)
                    blocked = True
                    break  # payload not here yet; pull + retry next tick
                del pend[cursor]
                cursor += 1
            if cursor != int(self.app_exec_slot[g]):
                self.app_exec_slot[g] = cursor
                self._app_exec_dirty.add(g)
            if blocked:
                # (re)start the timer whenever the parked SLOT changes:
                # only a cursor truly stuck at one slot should trip the
                # pull — a straggler making net progress through payload
                # pulls is healing normally
                ent = self._payload_blocked.get(g)
                if ent is None or ent[1] != cursor:
                    self._payload_blocked[g] = (self._tick_no, cursor)
            else:
                self._payload_blocked.pop(g, None)
            if not pend:
                del self.pending_exec[g]
        return missing

    def _app_execute_retrying(self, req, do_not_reply: bool) -> None:
        """Retry-forever execute (``PaxosInstanceStateMachine.java:
        1647-1734``): a deterministic app must eventually execute a decided
        request — giving up would silently skip a slot and diverge the
        RSM, so the only alternatives are retry or wedge.  Backoff grows
        1ms -> 100ms; sustained failure surfaces loudly (DelayProfiler
        counter at /stats + a periodic WARNING log line) instead of
        raising into the tick loop."""
        delay = 0.001
        attempt = 0
        while True:
            try:
                if self.app.execute(req, do_not_reply_to_client=do_not_reply):
                    return
            except Exception:
                pass
            attempt += 1
            DelayProfiler.update_count("app_execute_retries")
            if attempt in (10, 100) or attempt % 1000 == 0:
                self.log.warning(
                    "app refusing to execute %s#%s (%d attempts); "
                    "retrying forever (node is wedged until it succeeds)",
                    req.paxos_id, req.request_id, attempt,
                )
            time.sleep(delay)
            delay = min(delay * 2, 0.1)

    def _cache_response(self, request_id: int, response: Optional[str],
                        name: str) -> None:
        self.response_cache[request_id] = (time.time(), response, name)
        if len(self.response_cache) > self.response_cache_cap:
            self._evict_response_cache()

    @staticmethod
    def _cacheable(req) -> bool:
        """False for RETRYABLE refusals (``req.txn_retry``, set by the
        transaction plane when a request bounces off a locked group):
        caching one would freeze the refusal under exactly-once dedup
        and the same request id could never succeed after the lock
        clears.  Deterministic across replicas — the refusal is computed
        from replicated lock state and mutates nothing, so every member
        skips the cache for the same decided entry."""
        return not getattr(req, "txn_retry", False)

    def _evict_response_cache(self) -> None:
        """Size bound (RESPONSE_CACHE_SIZE analog): evict the oldest
        tenth so the cache (and its state-transfer ride-along) stays
        bounded under sustained load between checkpoint GCs.  Eviction
        is per-node (like the reference's time+size-GC'd
        GCConcurrentHashMap): exactly-once is guaranteed within the
        TTL/size window, not beyond it.

        Evicts the INSERTION-ORDER head: entries land with a fresh
        timestamp, so dict order ≈ age order (a restored/installed
        older entry can be slightly mis-ranked — the window is a
        heuristic either way).  The previous full timestamp sort was
        O(cap·log cap) per eviction — sampling-profiled at ~25% of a
        loaded core at 20k req/s across three replicas."""
        n = max(1, len(self.response_cache) // 10)
        for rid in list(itertools.islice(self.response_cache, n)):
            del self.response_cache[rid]

    def _execute_one(self, name: Optional[str], g: int, slot: int, vid: int) -> bool:
        if vid == 0:  # NOOP hole-filler: nothing to execute
            return True
        payload = self.arena.get(vid)
        if payload is None:
            return False
        if vid & BATCH_BIT:
            # one decided slot carrying an ordered batch of client
            # requests: unpack and run each through the app.  Every
            # replica decodes the same payload in the same order, and the
            # per-sub-request dedup decision is deterministic across the
            # group (same decided sequence, same earlier executions), so
            # the RSM stays convergent.  Hot loop: the clock and the
            # cache size-bound check amortize once per BATCH (at 2000
            # sub-requests/slot the per-request constants here are the
            # replica's whole execution budget).
            now = time.time()
            rc = self.response_cache
            nm = name or ""
            my = self.my_id
            tr_on = self.tracer.enabled
            for request_id, entry, value in decode_batch(payload):
                if request_id in rc:
                    if entry == my:
                        cb = self.outstanding.pop(request_id)
                        if cb is not None:
                            self._fired_callbacks.append(
                                (cb, request_id, rc[request_id][1])
                            )
                    continue
                req = SlimRequest(nm, request_id, value)
                self._app_execute_retrying(req, do_not_reply=(entry != my))
                self.total_executed += 1
                tc = self.trace_ctx.get(request_id) \
                    if self.trace_ctx else None
                if tr_on or tc is not None:
                    self.tracer.note(request_id, "execute", name=nm,
                                     node=my, row=g, slot=slot, batch=True,
                                     force=tc is not None,
                                     **self._tc_detail(tc))
                self.inflight.pop(request_id, None)
                response = req.response_value
                if self._cacheable(req):
                    rc[request_id] = (now, response, nm)
                if entry == my:
                    cb = self.outstanding.pop(request_id)
                    if cb is not None:
                        self._fired_callbacks.append(
                            (cb, request_id, response)
                        )
            if len(rc) > self.response_cache_cap:
                self._evict_response_cache()
            self._slots_since_ckpt += 1
            self.retained[vid] = (g, slot)
            return True
        entry, request_id = self.vid_meta.get(vid, (-1, vid))
        if request_id in self.response_cache:
            # duplicate of an already-executed request (client retransmit
            # through a different entry replica): skip re-execution on
            # EVERY replica — deterministic, since all see the same
            # decided sequence and the same earlier execution.
            if entry == self.my_id:
                cb = self.outstanding.pop(request_id)
                if cb is not None:
                    self._fired_callbacks.append(
                        (cb, request_id, self.response_cache[request_id][1])
                    )
            self.retained[vid] = (g, slot)
            return True
        req = SlimRequest(
            name or "", request_id, payload, stop=bool(vid & STOP_BIT)
        )
        self._app_execute_retrying(req, do_not_reply=(entry != self.my_id))
        self.total_executed += 1
        tc = self.trace_ctx.get(request_id) if self.trace_ctx else None
        if self.tracer.enabled or tc is not None:
            self.tracer.note(request_id, "execute", name=name or "",
                             node=self.my_id, row=g, slot=slot,
                             stop=bool(vid & STOP_BIT),
                             force=tc is not None, **self._tc_detail(tc))
        self._slots_since_ckpt += 1
        self.inflight.pop(request_id, None)
        response = getattr(req, "response_value", None)
        # cache BEFORE the stop hook: the hook snapshots (app state,
        # dedup set) as the epoch-final handoff pair, and the app state
        # it captures INCLUDES this stop execution — a snapshot whose
        # dedup set lacks the stop's own entry is an inconsistent pair
        # (chaos-sweep forensics: every breach diff was missing exactly
        # one epoch-final stop id)
        if self._cacheable(req):
            self._cache_response(request_id, response, name or "")
        if (vid & STOP_BIT) and self.on_stop_executed is not None and name:
            epoch = int(self._np("version")[g])
            try:
                self.on_stop_executed(name, g, epoch)
            except Exception:
                pass  # reconfiguration-layer hook must not wedge execution
        if entry == self.my_id:
            cb = self.outstanding.pop(request_id)
            if cb is not None:
                self._fired_callbacks.append((cb, request_id, response))
        self.retained[vid] = (g, slot)  # keep for straggler pulls
        return True

    # ------------------------------------------------------------------
    # THE data-plane straggler sync protocol — the one heal path for
    # every way a member falls behind, mirroring the reference's single
    # sync state machine (detect stall -> request missing decisions ->
    # checkpoint transfer if too far behind,
    # PaxosInstanceStateMachine.java:2161-2340; StatePacket /
    # handleCheckpoint:1744; jumpSlot, PaxosAcceptor.java:538).  Missing
    # DECISIONS within the window heal through the blob rings + payload
    # pulls (need_payloads); everything beyond heals here: detection
    # (_maybe_request_state) -> state_request to a rotated donor ->
    # _apply_state_reply (full checkpoint jump, small-gap jump once
    # provably stalled, or app-cursor adoption).  The control-plane
    # sibling for stranded EPOCH forms (pause records, pending rows) is
    # the reconfigurator's epoch_probe.
    # ------------------------------------------------------------------
    STATE_REQ_INTERVAL = 16  # ticks between pulls for the same row
    PAYLOAD_BLOCKED_TICKS = 64  # parked-on-missing-payload pull trigger
    FRONTIER_STALLED_TICKS = 64  # behind-majority-without-progress trigger

    def _maybe_request_state(self, out_np) -> None:
        """Detect rows needing a state pull: (a) device frontier stranded
        beyond the ring window — the decisions it needs left every peer's
        [G, W] ring (the SyncDecisionsPacket 'isMissingTooMuch' case), or
        (b) the APP cursor stranded behind the local device frontier past
        the retention horizon — the payloads it needs were GC'd everywhere
        (only the app state + cursor need transfer, not an engine jump),
        or (c) the cursor parked on a missing payload for many ticks at
        ANY gap size — a short-history group whose payloads were GC'd
        before this member joined fits under both horizons yet can never
        execute its way forward, or (d) the device frontier strictly
        behind the majority with NO progress for many ticks at ANY gap —
        the needed decisions can leave every peer's window entirely (a
        majority that paused+resumed keeps only >= frontier remnants),
        and a row in this state must heal by a (small-gap) jump."""
        W = self.cfg.window
        # post-step frontier derived from the step outputs (exec_base +
        # newly executed) — the profiler caught the per-tick
        # _np("exec_slot") device pull at ~4% of a loaded core, paid on
        # EVERY tick for a detector that almost never fires
        exec_np = (
            out_np.exec_base.astype(np.int64)
            + out_np.n_committed.astype(np.int64)
        )
        behind_dev = (out_np.maj_exec - exec_np) > W
        behind_app = (exec_np - self.app_exec_slot) > self.jump_horizon
        need = behind_dev | behind_app
        for g, (t0, _slot) in self._payload_blocked.items():
            if self._tick_no - t0 > self.PAYLOAD_BLOCKED_TICKS:
                need[g] = True
        # (d) frontier-stalled tracking, vectorized: (re)arm whenever the
        # stalled SLOT changes; rows making progress or caught up disarm.
        # Behind is measured against the MAX known frontier (own device
        # frontier vs every peer's gossiped app cursor), not the majority
        # frontier: the chaos soak found the inverted shape too — a
        # MAJORITY stranded behind one resumed member, where maj_exec
        # equals the stragglers' own frontier and a majority-based
        # detector never fires (yet only that one member can donate the
        # decisions, which left every window).
        mask_np = self._np("member_mask")
        peak = np.maximum(
            exec_np.astype(np.int64), out_np.maj_exec.astype(np.int64)
        )
        for r, arr in self.peer_app_exec.items():
            in_grp = ((mask_np >> r) & 1) == 1
            peak = np.maximum(peak, np.where(in_grp, arr, 0))
        behind = peak > exec_np
        rearm = behind & (self._stall_slot != exec_np)
        self._stall_since = np.where(
            rearm, self._tick_no, np.where(behind, self._stall_since, -1)
        )
        self._stall_slot = np.where(behind, exec_np, -1)
        need |= (
            behind & (self._stall_since >= 0)
            & (self._tick_no - self._stall_since > self.FRONTIER_STALLED_TICKS)
        )
        for g in self._needs_state:
            need[g] = True
        if self.hydrating_rows:
            # un-hydrated rows LOOK app-lagged (cursor parked at the
            # checkpoint frontier by design) but need hydration, not a
            # donor pull — pulling would adopt peer state that the
            # hydrator later overwrites with the stale checkpoint copy.
            # Rows still behind after hydration pull on the next tick
            need[np.fromiter(self.hydrating_rows, np.int64)] = False
        if not need.any():
            return
        versions = self._np("version")
        masks = self._np("member_mask")
        by_dst: Dict[int, List[Dict]] = {}
        for g in np.nonzero(need)[0]:
            g = int(g)
            name = self.row_name.get(g)
            if name is None or self.names.get(name) != g:
                continue  # only current-epoch mappings pull state
            if self._tick_no - self._last_state_req.get(g, -(10 ** 9)) \
                    < self.STATE_REQ_INTERVAL:
                continue
            self._last_state_req[g] = self._tick_no
            # one donor per request, rotated across the membership so a
            # dead/lagging donor doesn't wedge the pull (and the broadcast
            # doesn't N-plicate O(cache) replies)
            members = [r for r in range(32)
                       if (int(masks[g]) >> r) & 1 and r != self.my_id]
            if not members:
                continue
            dst = members[(self._tick_no // self.STATE_REQ_INTERVAL) % len(members)]
            by_dst.setdefault(dst, []).append(
                {"row": g, "name": name, "version": int(versions[g])}
            )
        for dst, rows in by_dst.items():
            self.forward_out.append(
                (dst, "state_request", {"rows": rows, "from": self.my_id})
            )

    def _serve_state_request(self, body: Dict) -> None:
        """Serve a consistent (device frontier == app cursor) snapshot of
        each requested row; skip rows where the two disagree — the
        requester retries and another peer may be quiescent."""
        # donor snapshots pair device frontier with the app cursor: an
        # in-flight step would advance one but not (yet) the other
        self._await_step_locked()
        exec_np = self._np("exec_slot")
        states = []
        for ent in body["rows"]:
            g, name = int(ent["row"]), ent["name"]
            if self.names.get(name) != g:
                continue
            if g in self._needs_state:
                continue  # blank-joined myself: serving my empty state
                # would "heal" another blank member into blankness
            if g in self.hydrating_rows:
                continue  # un-hydrated (recovery plane): my app state is
                # still the pre-restore blank — donating it would
                # "heal" the requester into blankness too
            if int(self._np("version")[g]) != int(ent["version"]):
                continue
            frontier = int(exec_np[g])
            if int(self.app_exec_slot[g]) != frontier:
                continue  # app cursor lags the device: snapshot inconsistent
            bal = int(self._np("bal")[g])
            states.append(StatePacket(
                paxos_id=name, version=int(ent["version"]),
                ballot_num=int(ballot_num(bal)),
                ballot_coord=int(ballot_coord(bal)),
                slot=frontier, row=g,
                app_hash=int(self._np("app_hash")[g]),
                n_execd=int(self._np("n_execd")[g]),
                stopped=int(self._np("stopped")[g]),
                state=self.app.checkpoint(name),
            ).to_json())
        if states:
            # The FULL (TTL+size-bounded) response cache rides along:
            # without these entries the receiver cannot dedup a duplicate
            # decision (same request id, different vid) landing after its
            # jumped frontier — replicas that executed the first copy skip
            # it, a jumped replica would execute it and DIVERGE the RSM.
            # Filtering by the retained-payload index proved unsound: a
            # re-proposed duplicate's first execution can predate payload
            # GC, leaving the one dedup entry that matters out of the
            # filter (caught by the chaos soak).
            # entries for the SERVED names only, over their in-TTL
            # history (no dependence on payload retention), BOUNDED: a
            # hot name's cache can hold tens of thousands of entries and
            # shipping all of them makes every straggler pull O(cache)
            # (VERDICT r3 weak #5).  The newest `cap` entries per name
            # ship; older ones fall outside the same probabilistic
            # exactly-once window the per-node TTL+size eviction already
            # defines (a duplicate older than the window can re-execute
            # on ANY replica, transferred state or not).
            served = {s_["paxos_id"] for s_ in states}
            by_name: Dict[str, list] = {}
            for rid, (t, resp, nm) in self.response_cache.items():
                if nm in served:
                    by_name.setdefault(nm, []).append((t, rid, resp))
            cap = max(1024, self.response_cache_cap // 8)
            cache = {}
            for nm, ents in by_name.items():
                if len(ents) > cap:
                    ents.sort()  # oldest first; keep the newest cap
                    ents = ents[-cap:]
                for t, rid, resp in ents:
                    cache[str(rid)] = [t, resp, nm]
            self.forward_out.append(
                (body["from"], "state_reply",
                 {"states": states, "response_cache": cache})
            )

    def _apply_state_reply(
        self, states: List[Dict], response_cache: Optional[Dict] = None
    ) -> None:
        """Adopt donor frontiers for rows still stranded (jumpSlot).
        Entries are StatePacket JSON (the CHECKPOINT_STATE wire schema)."""
        from .ops.lifecycle import jump_rows

        # a state jump replaces engine rows: it must observe a COMPLETED
        # tick (an in-flight step's post-step would otherwise process
        # out_np against rows this jump just rewrote)
        self._await_step_locked()
        W = self.cfg.window
        exec_np = self._np("exec_slot")
        jumps: List[Dict] = []      # engine jump + app restore
        app_only: List[Dict] = []   # app restore only (device was current)
        states = [
            {
                "row": int(p_.row), "name": p_.paxos_id,
                "version": int(p_.version), "exec": int(p_.slot),
                "bal": int(encode_ballot(p_.ballot_num, p_.ballot_coord)),
                "app_hash": int(p_.app_hash),
                "n_execd": int(p_.n_execd),
                "stopped": int(p_.stopped),
                "app_state": p_.state,
            }
            for p_ in (StatePacket.from_json(e) for e in states)
        ]
        for ent in states:
            g, name = int(ent["row"]), ent["name"]
            if self.names.get(name) != g:
                continue
            if int(self._np("version")[g]) != int(ent["version"]):
                continue
            donor_exec = int(ent["exec"])
            my_exec = int(exec_np[g])
            stalled = (
                int(self._stall_since[g]) >= 0
                and self._tick_no - int(self._stall_since[g])
                > self.FRONTIER_STALLED_TICKS
                and int(self._stall_slot[g]) == my_exec
            )
            if donor_exec >= my_exec + W or (
                stalled and donor_exec > my_exec
            ):
                # jump clear past my ring, OR any positive gap once the
                # frontier has provably stalled (the needed decisions
                # left every peer's window — rings can't heal it).  Safe
                # at any gap: jump_rows keeps window lanes at/above the
                # adopted frontier, so no live vote is forgotten
                jumps.append(ent)
            elif donor_exec <= my_exec and (
                donor_exec > int(self.app_exec_slot[g])
                or (g in self._needs_state
                    and donor_exec >= int(self.app_exec_slot[g]))
            ):
                # device is current but the APP cursor stranded behind the
                # payload-retention horizon: adopt the donor's app state at
                # its (<= mine) frontier and resume host execution from
                # there — no engine surgery needed or safe
                app_only.append(ent)
        if not jumps and not app_only:
            return
        if jumps:
            self.state = jump_rows(
                self.state,
                np.array([e["row"] for e in jumps]),
                np.array([e["exec"] for e in jumps]),
                np.array([e["bal"] for e in jumps]),
                np.array([e["app_hash"] for e in jumps]),
                np.array([e["n_execd"] for e in jumps]),
                np.array([e["stopped"] for e in jumps]),
            )
        # install the donor's dedup entries ONLY for names whose state
        # was actually ADOPTED here: an entry is sound exactly when it is
        # paired with a state that contains its execution.  Installing a
        # served-but-not-adopted name's entries would DEDUP-SKIP this
        # member's own parked executions of those requests once their
        # payloads arrive — a truncated history with a full dedup set
        # (the chaos sweeps' remaining breach shape: identical dedup
        # sets, app_n_executed 5 vs 3 at equal frontiers).
        adopted = {e["name"] for e in jumps} | {e["name"] for e in app_only}
        self.install_dedup({
            rid: ent for rid, ent in (response_cache or {}).items()
            if str(ent[2]) in adopted
        })
        for ent in jumps:
            g = int(ent["row"])
            self.app.restore(ent["name"], ent["app_state"])
            self.app_exec_slot[g] = int(ent["exec"])
            self._app_exec_dirty.add(g)
            self.pending_exec.pop(g, None)
            self._payload_blocked.pop(g, None)
            self._stall_since[g] = -1
            self._stall_slot[g] = -1
            self._needs_state.discard(g)
            # donor state supersedes the checkpoint copy: the hydrator
            # must NOT later restore the older shard state over it
            self.hydrating_rows.discard(g)
            if int(ent["stopped"]) and self.on_stop_executed is not None:
                # the STOP decision will never execute locally (the jump
                # landed past it) — fire the hook now so the epoch layer
                # captures the final state and acks pending stops
                try:
                    self.on_stop_executed(
                        ent["name"], g, int(ent["version"])
                    )
                except Exception:
                    pass
        for ent in app_only:
            g = int(ent["row"])
            self.app.restore(ent["name"], ent["app_state"])
            self.app_exec_slot[g] = int(ent["exec"])
            self._app_exec_dirty.add(g)
            self._payload_blocked.pop(g, None)
            self._stall_since[g] = -1
            self._stall_slot[g] = -1
            self._needs_state.discard(g)
            self.hydrating_rows.discard(g)  # donor state supersedes shard
            pend = self.pending_exec.get(g)
            if pend:  # decisions at/past the adopted cursor still execute
                for slot in [s for s in pend if s < int(ent["exec"])]:
                    del pend[slot]
        # make the adoption durable at the next cadence point (debounced:
        # several replies in one burst must not each snapshot the engine);
        # until then a crash merely rewinds to a state the pull re-heals
        self._slots_since_ckpt = max(self._slots_since_ckpt, self.checkpoint_every)

    # ------------------------------------------------------------------
    # checkpointing (consistentCheckpoint analog, :1553-1615)
    # ------------------------------------------------------------------
    def _maybe_checkpoint(self, out_np) -> None:
        if self.logger is None or self._slots_since_ckpt < self.checkpoint_every:
            return
        self.checkpoint_now()

    def checkpoint_now(self) -> None:
        if self.logger is None:
            return
        if self.hydrating_rows:
            # a snapshot taken mid-hydration would persist the
            # pre-restore blank app states of every cold name as a NEWER
            # generation — catastrophic.  Defer to the next cadence
            # point; background hydration bounds the wait
            self.metrics.count("recovery_checkpoint_deferred")
            return
        with self._state_lock:
            # snapshots must capture a COMPLETED tick (engine arrays and
            # host cursors from the same cycle)
            self._await_step_locked()
        t_ck = time.monotonic()
        self._checkpoint_now_inner()
        DelayProfiler.update_delay("checkpoint", t_ck)
        DelayProfiler.update_count("t_checkpoint", time.monotonic() - t_ck)

    def _checkpoint_now_inner(self) -> None:
        # _np returns donation-safe PRIVATE host arrays (never zero-copy
        # views of the device buffers — see its docstring), so the async
        # writer can serialize them while later donated ticks overwrite
        # the device state in place; going through it also shares the
        # per-state-version cache with the hot accessors
        arrays = {k: self._np(k) for k in self.state._fields}
        app_states = {
            name: self.app.checkpoint(name) for name in self.names
        }
        # the live arena is exactly the payload set still needed by some
        # replica (pending execution locally or retained for stragglers);
        # pre-checkpoint PAYLOADS journal blocks are unreachable after this
        # snapshot's GC, so they must travel in the snapshot itself
        # app_states correspond to the APP cursor (app_exec_slot), which
        # can trail the device frontier when payloads are in flight; the
        # in-between (slot -> vid) map rides along so recovery resumes
        # execution exactly where the app state string left off.
        # checkpoint_async: every container below is a FRESH object (dict
        # comps / copies) captured under the manager lock — the writer
        # thread serializes them while the tick keeps running (a loaded
        # snapshot costs ~0.5s of json+npz+fsync; paying it in the tick
        # was the measured latency spike that failed the capacity gate)
        # recency hints for the recovery plane's hot set: rows ordered by
        # last activity, newest first (one argsort per checkpoint).  The
        # next restart hydrates these names before serving
        act = self.row_activity
        # hint enough rows to cover the configured hot budget (operators
        # can raise RECOVERY_HOT_NAMES past the floor).  argpartition,
        # not a full argsort: this runs in the tick-blocking snapshot
        # section, and O(G log G) at 1M+ rows is the same in-tick
        # latency shape the async writer exists to avoid
        cap = max(16384, Config.get_int(PC.RECOVERY_HOT_NAMES))
        cap = min(cap, len(act))
        top = np.argpartition(-act, cap - 1)[:cap] if cap else np.array([], np.int64)
        top = top[np.argsort(-act[top], kind="stable")]
        hot_rows = [
            int(r) for r in top
            if act[r] > 0 and int(r) in self.row_name
        ]
        self.logger.checkpoint_async(arrays, app_states, {
            "hot_rows": hot_rows,
            "names": dict(self.names),
            "pending_rows": sorted(self.pending_rows),
            "needs_state": sorted(self._needs_state),
            "response_cache": {
                str(rid): [t, resp, nm]
                for rid, (t, resp, nm) in self.response_cache.items()
                if t >= time.time() - self.response_cache_ttl
            },
            "paused": {
                f"{n}@{e}": rec for (n, e), rec in (
                    self.paused.peek_items()
                    if hasattr(self.paused, "peek_items")
                    else self.paused.items()
                )
            },
            "old_epochs": [[n, e, r] for (n, e), r in self.old_epochs.items()],
            "next_counter": self._next_counter,
            "arena": dict(self.arena),
            "vid_meta": {k: list(v) for k, v in self.vid_meta.items()},
            "app_exec_slot": self.app_exec_slot.tolist(),
            "pending_exec": {
                str(g): {str(s_): v for s_, v in pend.items()}
                for g, pend in self.pending_exec.items()
            },
        })
        self._slots_since_ckpt = 0
        # response-cache GC piggybacks on checkpoint cadence
        cut = time.time() - self.response_cache_ttl
        for key in [k for k in self.response_cache
                    if self.response_cache[k][0] < cut]:
            del self.response_cache[key]

    def drain_forward_out(self) -> List[Tuple[int, str, Dict]]:
        """Atomically take the pending outbound host-channel messages.
        An unlocked swap could lose a message appended by a transport
        thread between the load and the store."""
        with self._state_lock:
            out, self.forward_out = self.forward_out, []
        return out

    def blob(self) -> Blob:
        """Current publishable snapshot (what peers gather)."""
        return make_blob(self.state)

    def blob_vec(self) -> np.ndarray:
        """Packed publish vector for the current state (the wire body of
        a `D` frame); used by the socket runtime at boot and after
        lifecycle ops, before the first packed tick returns one."""
        return self.publish_snapshot()[0]

    def publish_snapshot(self) -> Tuple[np.ndarray, EngineState]:
        """(packed publish vector, the exact state it was computed from),
        captured atomically — callers caching the pair can then detect
        staleness by state identity without racing lifecycle ops."""
        with self._state_lock:
            state = self.state
            return to_host(
                make_blob_vec(state, self.kernel_launches)
            ), state

    def close(self) -> None:
        if self.hydrator is not None:
            self.hydrator.stop()
        if self.logger:
            self.logger.close()
