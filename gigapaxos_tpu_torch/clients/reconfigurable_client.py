"""ReconfigurableAppClient — the reconfiguration-aware client.

API-parity target: ``ReconfigurableAppClientAsync``
(``ReconfigurableAppClientAsync.java:75,798-1404``): resolve a name's
active replicas through any reconfigurator, cache with TTL, send app
requests to actives, refresh on ``unknown_name`` (a request landing
mid-migration), and expose the create/delete/reconfigure name API.

Wire shape (shared substrate: :mod:`gigapaxos_tpu_torch.clients.base`): app
requests are ``client_request`` frames to actives (answered
``client_response`` on the same connection); reconfigurator ops are
``rc_client`` frames to any RC (answered ``rc_client_reply``, possibly
relayed from the record's primary — see
:mod:`gigapaxos_tpu_torch.reconfigurable_node`).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..net.codec import decode_json, decode_kind, encode_json
from ..net.rtt import LatencyAwareRedirector
from ..reconfiguration.rc_config import RC
from ..utils.config import Config
from .base import Addr, AsyncFrameClient


class ReconfigurableAppClient(AsyncFrameClient):
    def __init__(
        self,
        actives: Dict[int, Addr],
        reconfigurators: List[Addr],
        my_tag: int = -1,
    ):
        super().__init__()
        self.actives = dict(actives)
        self.reconfigurators = list(reconfigurators)
        self.my_tag = my_tag
        self.cache_ttl = Config.get_float(RC.ACTIVES_CACHE_TTL_S)
        # nearest-replica selection (E2ELatencyAwareRedirector analog):
        # learned per-active latency EWMA with a probe ratio
        self.redirector = LatencyAwareRedirector()
        # name -> (expiry, [active ids]) — the TTL'd request->actives table
        self._actives_cache: Dict[str, Tuple[float, List[int]]] = {}
        # echo-probe round in flight: actives awaited + completion event;
        # replies carry the round number back so a LATE reply from an
        # earlier round cannot complete (or undercount) the current one
        self._probe_pending: set = set()
        self._probe_round = 0
        self._probe_done = threading.Event()
        # app-request callbacks:
        # request_id -> (send_time, cb(rid, resp, error), target, n_sends)
        self._callbacks: Dict[int, Tuple[float, Callable, Optional[int], int]] = {}
        # rc-op waiters: (ack_kind, name) -> (event, box)
        self._rc_waiters: Dict[Tuple[str, str], Tuple[threading.Event, Dict]] = {}

    @classmethod
    def from_properties(cls) -> "ReconfigurableAppClient":
        """Build the address books from ``active.*``/``reconfigurator.*``
        config entries (ids by sorted name, matching NodeConfig).  With
        the CLIENT_SSL_MODE port split configured, client traffic targets
        each node's client-facing listener at port + CLIENT_PORT_OFFSET."""
        from ..net.ssl_util import client_plane_split
        from ..paxos_config import PC

        off = (
            Config.get_int(PC.CLIENT_PORT_OFFSET)
            if client_plane_split() else 0
        )
        ar = Config.node_addresses("active")
        rc = Config.node_addresses("reconfigurator")
        return cls(
            {i: (ar[n][0], ar[n][1] + off)
             for i, n in enumerate(sorted(ar))},
            [(rc[n][0], rc[n][1] + off) for n in sorted(rc)],
        )

    # ------------------------------------------------------------------
    # latency orientation (EchoRequest analog, Reconfigurator.java:2420)
    # ------------------------------------------------------------------
    def probe_actives(self, wait_s: float = 1.0) -> int:
        """Echo-probe every known active and SEED the redirector's RTT
        estimates from the replies, so the very first ``send_request``
        pick is latency-oriented instead of arbitrary (cold start was
        previously blind until real traffic taught the EWMA).  Blocks up
        to ``wait_s`` for the round to complete; returns how many actives
        have an estimate afterwards.  Safe to call repeatedly — seeding
        never overwrites traffic-learned estimates."""
        with self._lock:
            self._probe_pending = set(self.actives)
            self._probe_round += 1
            rnd = self._probe_round
            self._probe_done.clear()
        for aid, addr in self.actives.items():
            # ts stamped PER SEND: one shared stamp would fold the
            # serialization/connect time of every earlier send into the
            # later actives' RTTs, making the seeded ordering track probe
            # order instead of network latency
            self.send_frame(addr, encode_json("echo", self.my_tag, {
                "ts": time.time(), "round": rnd,
            }))
        if wait_s > 0:
            self._probe_done.wait(wait_s)
        return sum(
            1 for aid in self.actives
            if self.redirector.rtt.get(int(aid)) is not None
        )

    def _on_echo_reply(self, body: Dict, sender: int) -> None:
        ts = body.get("ts")
        if ts is None:
            return
        # the RTT is valid whichever round it came from (measured against
        # its OWN send stamp) — only the round bookkeeping is gated
        rtt = max(0.0, time.time() - float(ts))
        self.redirector.seed(int(sender), rtt)
        with self._lock:
            if body.get("round") != self._probe_round:
                return  # a straggler from an earlier probe round
            self._probe_pending.discard(int(sender))
            if not self._probe_pending:
                self._probe_done.set()

    # ------------------------------------------------------------------
    # name management (create/delete/reconfigure via any RC)
    # ------------------------------------------------------------------
    def _rc_op_sync(
        self, kind: str, ack_kind: str, name: str, body: Dict,
        timeout: float = 10.0, retransmit_every: float = 1.0,
    ) -> Optional[Dict]:
        """One RC op with retransmission.  A "not-ready" answer (record
        mid-transition — e.g. a paused name being reactivated by this very
        touch) is retried until the deadline rather than surfaced."""
        frame = encode_json("rc_client", self.my_tag, {"kind": kind, "body": body})
        deadline = time.time() + timeout
        i = random.randrange(len(self.reconfigurators))
        last: Optional[Dict] = None
        while time.time() < deadline:
            ev = threading.Event()
            box: Dict = {}
            key = (ack_kind, name)
            with self._lock:
                self._rc_waiters[key] = (ev, box)
            try:
                self.send_frame(
                    self.reconfigurators[i % len(self.reconfigurators)], frame
                )
                i += 1  # rotate RCs on retransmit (ops are idempotent)
                if not ev.wait(retransmit_every):
                    continue
                last = box.get("body")
            finally:
                with self._lock:
                    self._rc_waiters.pop(key, None)
            if last and not last.get("ok") and \
                    last.get("reason") in ("not-ready", "paused"):
                time.sleep(min(0.25, retransmit_every))
                continue
            return last
        return last

    def create_name(
        self, name: str, initial_state: Optional[str] = None,
        actives: Optional[List[int]] = None, timeout: float = 10.0,
    ) -> Optional[Dict]:
        body = {"name": name, "initial_state": initial_state}
        if actives is not None:
            body["actives"] = list(actives)
        ack = self._rc_op_sync(
            "create_service", "create_ack", name, body, timeout
        )
        if ack and not ack.get("ok") and ack.get("reason") == "exists":
            # A slow create's RETRANSMIT can find the record this client
            # just created and answer "exists" ahead of the relayed ok —
            # confirm via resolution (retried creates are success-if-exists,
            # the reference's DuplicateNameException handling).
            acts = self.request_actives(name, force=True)
            if acts:
                return {"name": name, "ok": True, "actives": acts,
                        "existed": True}
        return ack

    def create_names(
        self,
        names,
        timeout: float = 30.0,
        retransmit_every: float = 2.0,
    ) -> Dict[str, Dict]:
        """Batched create (``sendRequest`` batched-CreateServiceName
        parity, ``Reconfigurator.java:484-680``): N names are split by
        RC-ring ownership and each owning RC gets ONE
        ``create_service_batch`` round trip — mass-creating names costs a
        few RTs per RC group, not one per name.  `names` is a list of
        names or (name, initial_state) pairs.  Returns {name: result};
        names the RC reports ``forwarded`` (client/server ring drift) are
        retried individually."""
        from ..reconfiguration.chash import ConsistentHashing

        ring = ConsistentHashing(list(range(len(self.reconfigurators))))
        by_rc: Dict[int, List[Dict]] = {}
        for item in names:
            name, init = item if isinstance(item, tuple) else (item, None)
            rc = ring.get_replicated_servers(name, 1)[0]
            by_rc.setdefault(rc, []).append(
                {"name": name, "initial_state": init}
            )
        results: Dict[str, Dict] = {}
        for rc, creates in by_rc.items():
            batch_id = f"b{self.mint_id()}"
            got = self._batch_create_sync(
                rc, batch_id, creates, timeout, retransmit_every
            )
            results.update(got or {})
        for nm, res in list(results.items()):
            if res.get("reason") == "forwarded":
                # the RC already forwarded the create to its owner (with
                # no reply registration) — retry individually until the
                # in-flight creation resolves; a plain "exists" with
                # unresolvable actives means it is still mid-flight, so
                # poll a few rounds before reporting it
                deadline = time.time() + timeout
                while time.time() < deadline:
                    ack = self.create_name(nm, timeout=retransmit_every * 2)
                    if ack and (ack.get("ok") or ack.get("reason")
                                not in (None, "exists")):
                        results[nm] = ack
                        break
                    if ack:
                        results[nm] = ack
                    time.sleep(0.25)
        return results

    def _batch_create_sync(
        self, rc: int, batch_id: str, creates: List[Dict],
        timeout: float, retransmit_every: float,
    ) -> Optional[Dict]:
        """One batch round with retransmission (idempotent: existing
        names come back ok/existed).  After two dead attempts the batch
        rotates to another RC, which degrades gracefully by forwarding
        each name to its owner."""
        deadline = time.time() + timeout
        attempt = 0
        while time.time() < deadline:
            target = (rc + (attempt // 2)) % len(self.reconfigurators)
            attempt += 1
            ev = threading.Event()
            box: Dict = {}
            key = ("create_batch_ack", batch_id)
            with self._lock:
                self._rc_waiters[key] = (ev, box)
            try:
                self.send_frame(
                    self.reconfigurators[target],
                    encode_json("rc_client", self.my_tag, {
                        "kind": "create_service_batch",
                        "body": {"batch_id": batch_id, "creates": creates},
                    }),
                )
                if ev.wait(retransmit_every):
                    return box.get("body", {}).get("results")
            finally:
                with self._lock:
                    self._rc_waiters.pop(key, None)
        return None

    def send_request_anycast(
        self,
        name: str,
        value: str,
        callback: Callable,  # cb(request_id, response, error)
        request_id: Optional[int] = None,
    ) -> Optional[int]:
        """Send one request to EVERY active hosting the name; the first
        responder wins (``sendRequestAnycast``,
        ``ReconfigurableAppClientAsync.java:798-1404``).  The consensus
        layer dedupes the duplicate proposals by request id (exactly-once
        execution); client-side, the callback pops on the first success,
        and per-active errors surface only if ALL targets fail."""
        acts = self.request_actives(name)
        if acts is not None:
            acts = [a for a in acts if int(a) in self.actives]
        if not acts:
            return None
        if request_id is None:
            request_id = self.mint_id()
        n_targets = len(acts)
        errors: List[str] = []
        lock = self._lock

        def first_wins(rid, resp, error):
            if error:
                with lock:
                    errors.append(error)
                    all_failed = len(errors) >= n_targets
                    if all_failed:
                        self._callbacks.pop(rid, None)
                if all_failed:
                    callback(rid, None, error)
                return
            callback(rid, resp, None)

        with self._lock:
            # n_sends = n_targets disables RTT attribution (ambiguous)
            self._callbacks[request_id] = (
                time.time(), first_wins, None, n_targets,
            )
        for a in acts:
            self.send_request_body(self.actives[int(a)], {
                "name": name, "value": value,
                "request_id": request_id, "stop": False,
            })
        return request_id

    def delete_name(self, name: str, timeout: float = 10.0) -> Optional[Dict]:
        ack = self._rc_op_sync(
            "delete_service", "delete_ack", name, {"name": name}, timeout
        )
        if ack and not ack.get("ok") and ack.get("reason") == "unknown":
            # a completed delete's retransmit finds no record — confirm the
            # name is really gone (idempotent delete semantics).  Poll a
            # few times: a lagging RC may still serve the purged record
            # for a tick or two (RSM application skew).
            for _ in range(4):
                if self.request_actives(name, force=True) is None:
                    self.invalidate(name)
                    return {"name": name, "ok": True, "already_deleted": True}
                time.sleep(0.5)
        self.invalidate(name)
        return ack

    def add_active(self, node_id: int, timeout: float = 10.0) -> Optional[Dict]:
        """Elastic membership: admit a new active node (its address must
        already be in the cluster's address books)."""
        return self._rc_op_sync(
            "add_active", "add_active_ack", str(node_id),
            {"id": int(node_id)}, timeout,
        )

    def remove_active(self, node_id: int, timeout: float = 10.0) -> Optional[Dict]:
        """Elastic membership: retire an active; its groups migrate off."""
        return self._rc_op_sync(
            "remove_active", "remove_active_ack", str(node_id),
            {"id": int(node_id)}, timeout,
        )

    def reconfigure(
        self, name: str, new_actives: List[int], timeout: float = 15.0
    ) -> Optional[Dict]:
        return self._rc_op_sync(
            "reconfigure", "reconfigure_ack", name,
            {"name": name, "new_actives": list(new_actives)}, timeout,
        )

    def request_actives(
        self, name: str, timeout: float = 5.0, force: bool = False
    ) -> Optional[List[int]]:
        """Resolve the name's current actives (TTL cache; RC on miss)."""
        now = time.time()
        with self._lock:
            ent = self._actives_cache.get(name)
            if ent and ent[0] > now and not force:
                return list(ent[1])
        resp = self._rc_op_sync(
            "request_actives", "actives_response", name, {"name": name}, timeout
        )
        if not resp or not resp.get("ok"):
            return None
        acts = [int(a) for a in resp["actives"]]
        with self._lock:
            self._actives_cache[name] = (now + self.cache_ttl, acts)
        return acts

    def invalidate(self, name: str) -> None:
        with self._lock:
            self._actives_cache.pop(name, None)

    # ------------------------------------------------------------------
    # app requests (to actives, with unknown_name refresh)
    # ------------------------------------------------------------------
    def send_request(
        self,
        name: str,
        value: str,
        callback: Callable,  # cb(request_id, response, error)
        stop: bool = False,
        request_id: Optional[int] = None,
        active: Optional[int] = None,
    ) -> Optional[int]:
        acts = self.request_actives(name)
        if acts is not None:
            # only actives this client can actually address (a stale RC
            # answer may name a node missing from the local address book)
            acts = [a for a in acts if int(a) in self.actives]
        if not acts:
            return None
        target = active if active is not None else self.redirector.pick(acts)
        addr = self.actives.get(int(target))
        if addr is None:
            return None
        if request_id is None:
            request_id = self.mint_id()
        with self._lock:
            prev = self._callbacks.get(request_id)
            self._callbacks[request_id] = (
                time.time(), callback, int(target),
                (prev[3] + 1) if prev else 1,
            )
        if prev is not None and prev[2] is not None:
            # retransmission IS a latency signal: the previous target went
            # unanswered for the whole interval — record that elapsed time
            # as a floor sample, or a server slower than the retransmit
            # interval would never accumulate any RTT evidence at all
            self.redirector.record(prev[2], time.time() - prev[0])
        body = {
            "name": name, "value": value,
            "request_id": request_id, "stop": stop,
        }
        tc = self._mint_trace()
        if tc is not None:
            body["tc"] = list(tc)
        self.send_request_body(addr, body)
        return request_id

    def send_prepared(
        self,
        addr: Tuple[str, int],
        name: str,
        value: str,
        callback: Callable,
        request_id: Optional[int] = None,
    ) -> int:
        """Load-harness hot path: the caller pre-resolved the target, so
        skip actives resolution and redirector bookkeeping — ONE lock
        hold mints the id and registers the callback.  The capacity
        probe's injector was ~40%% of a loaded 1-core host through the
        full :meth:`send_request` path; at probe rates the per-request
        constant IS the measured system capacity."""
        with self._lock:
            if request_id is None:
                self._next_id += 1
                request_id = self._next_id
            # target None: no RTT attribution (the harness pins targets)
            self._callbacks[request_id] = (time.time(), callback, None, 1)
        body = {
            "name": name, "value": value, "request_id": request_id,
        }
        tc = self._mint_trace()
        if tc is not None:
            body["tc"] = list(tc)
        self.send_request_body(addr, body)
        return request_id

    def send_prepared_batch(
        self,
        addr: Tuple[str, int],
        items: List[Tuple[str, str]],
        callback: Callable,
        t0: Optional[float] = None,
    ) -> List[int]:
        """Bulk :meth:`send_prepared`: ONE lock hold mints ids and
        registers ``callback`` for every (name, value) in ``items``, and
        ONE aggregation enqueue carries the whole quantum — the
        injector's locks amortize per wake-up instead of per request."""
        now = time.time() if t0 is None else t0
        bodies = []
        trace = bool(self._trace_rate)
        with self._lock:
            rid0 = self._next_id + 1
            self._next_id += len(items)
            for k, (name, value) in enumerate(items):
                self._callbacks[rid0 + k] = (now, callback, None, 1)
        for k, (name, value) in enumerate(items):
            body = {
                "name": name, "value": value, "request_id": rid0 + k,
            }
            if trace:
                tc = self._mint_trace()
                if tc is not None:
                    body["tc"] = list(tc)
            bodies.append(body)
        self.send_request_bodies(addr, bodies)
        return list(range(rid0, rid0 + len(items)))

    def send_request_sync(
        self, name: str, value: str, timeout: float = 10.0,
        stop: bool = False, retransmit_every: float = 0.5,
    ) -> Optional[str]:
        """Blocking request with retransmission and mid-migration recovery:
        an ``unknown_name`` answer (the active no longer hosts the name —
        reconfigured away, or not yet confirmed) invalidates the cache and
        the retry resolves fresh actives through the RCs."""
        ev = threading.Event()
        out: Dict = {}

        def cb(rid, resp, error):
            if error == "overload":
                out["backoff"] = True  # shed at entry: retry after a beat
                ev.set()
                return
            if error:
                self.invalidate(name)
                ev.set()  # wake the loop for an immediate re-resolve
                return
            out["resp"] = resp
            out["done"] = True
            ev.set()

        rid = None
        deadline = time.time() + timeout
        while time.time() < deadline:
            ev.clear()
            rid = self.send_request(
                name, value, cb, stop=stop, request_id=rid
            )
            if rid is None:  # resolution failed; brief backoff then retry
                time.sleep(0.1)
                continue
            ev.wait(retransmit_every)
            if out.get("done"):
                with self._lock:
                    self._callbacks.pop(rid, None)
                return out.get("resp")
            if out.pop("backoff", None):
                # the shed reply came back instantly — an immediate resend
                # would HAMMER the overloaded entry faster than the normal
                # no-reply cadence; back off a full jittered interval
                time.sleep(retransmit_every * (1.0 + random.random()))
        if rid is not None:
            with self._lock:
                self._callbacks.pop(rid, None)
        return None

    # ------------------------------------------------------------------
    def _dispatch(self, payload: bytes) -> None:
        kind = decode_kind(payload)
        if kind == "S":  # binary response batch (hot path)
            from ..net import hot_codec

            try:
                sender, items = hot_codec.decode_response_batch(payload)
            except ValueError:
                return
            for sub in items:
                self._on_response(sub, sender)
            return
        if kind != "J":
            return
        k, sender, body = decode_json(payload)
        if k == "client_response":
            self._on_response(body, sender)
        elif k == "echo_reply":
            self._on_echo_reply(body, sender)
        elif k == "client_response_batch":
            for sub in body.get("resps", ()):
                self._on_response(sub, sender)
        elif k == "rc_client_reply":
            kind = body.get("kind")
            b = body.get("body") or {}
            with self._lock:
                ent = self._rc_waiters.get((kind, b.get("name")))
            if ent:
                ent[1]["body"] = b
                ent[0].set()

    def _on_response(self, body: Dict, sender: int) -> None:
        rid = int(body["request_id"])
        now = time.time()
        with self._lock:
            ent = self._callbacks.get(rid)
            if not body.get("error"):
                self._callbacks.pop(rid, None)
            self._gc_callbacks_locked(now)
        if ent:
            # RTT attribution only when it is unambiguous: the reply
            # came from the recorded target AND the request was sent
            # exactly once — under retransmission the send time is the
            # LATEST attempt's, so a slow server's late reply to the
            # first attempt would record a falsely tiny RTT
            if not body.get("error") and ent[2] is not None \
                    and int(sender) == int(ent[2]) and ent[3] == 1:
                self.redirector.record(ent[2], now - ent[0])
            if not body.get("error"):
                self._observe_latency(ent[0], now)
            ent[1](rid, body.get("response"), body.get("error"))
