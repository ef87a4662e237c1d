"""Two behaviours of the reconfiguration layer that the chip runs showed,
checked on both packages on the CPU, on the scripted clock of
``test_torch_reconfiguration.py``'s :class:`Twin` (both packages'
``ReconfigurableCluster`` in lock step, compared after every step).

* Batched creates of 64 and of 256 names: the cluster steps each batch
  takes, and how often a manager's state-replacing op found a step in
  flight and waited for it (the suspect for the growth seen over
  sockets, where each server ticks on its own thread).  The stepped
  cluster runs no step concurrently with an op: no op waits, and the
  steps grow no faster than the batch.
* The lossy stepped migration (30% of reconfiguration-plane messages
  dropped under a seeded generator): the steps it takes.

A difference between the packages would be a port fault; equal counts
make the behaviour the reference's.
"""

import numpy as np

from gigapaxos_tpu.manager import PaxosManager as JManager
from gigapaxos_tpu_torch.manager import PaxosManager as TManager
from gigapaxos_tpu.reconfiguration import active_replica as j_ar
from gigapaxos_tpu.reconfiguration import reconfigurator as j_rc
from gigapaxos_tpu_torch.reconfiguration import active_replica as t_ar
from gigapaxos_tpu_torch.reconfiguration import reconfigurator as t_rc
from test_torch_reconfiguration import _set_class_attrs, _twin


def _count_waits(monkeypatch):
    """Per package: calls of ``_await_step_locked``, and those that found
    a step in flight owned by another thread."""
    counts = {}
    for key, cls in (("jax", JManager), ("port", TManager)):
        c = counts[key] = {"calls": 0, "inflight": 0}
        orig = cls._await_step_locked

        def wrapped(self, _orig=orig, _c=c):
            _c["calls"] += 1
            if self._step_inflight:
                _c["inflight"] += 1
            return _orig(self)

        monkeypatch.setattr(cls, "_await_step_locked", wrapped)
    return counts


def _batch_create(monkeypatch, n):
    counts = _count_waits(monkeypatch)
    t = _twin(monkeypatch, ar=(n + 8, 8, 4, 3))
    try:
        names = [f"bn{i:04d}" for i in range(n)]
        by_rc = {}
        for nm in names:
            by_rc.setdefault(t.p.reconfigurators[0].primary_of(nm), []).append(nm)
        for rc, group in sorted(by_rc.items()):
            t.client_request("create_service_batch", {
                "batch_id": f"b{rc}",
                "creates": [{"name": nm, "actives": [0, 1, 2]} for nm in group],
            }, rc=rc)
        done, steps = {}, 0
        while len(done) < len(by_rc) and steps < 400:
            msgs, t.pending = t.pending, []
            for kind, body in msgs:
                if kind == "create_batch_ack":
                    done[body.get("batch_id")] = body
            if len(done) < len(by_rc):
                t.step()
                steps += 1
        results = {nm: r for b in done.values()
                   for nm, r in (b.get("results") or {}).items()}
        hosted = [sum(nm in m.names for nm in names) for m in t.p.ars.managers]
        return steps, results, hosted, counts
    finally:
        t.close()


def test_batched_create_growth_64_and_256(monkeypatch):
    got = {}
    for n in (64, 256):
        with monkeypatch.context() as mp:
            steps, results, hosted, counts = _batch_create(mp, n)
        assert len(results) == n and all(r.get("ok") for r in results.values())
        assert hosted == [n, n, n]
        assert counts["jax"] == counts["port"], counts
        assert counts["port"]["inflight"] == 0, counts
        got[n] = (steps, counts["port"]["calls"])
        print(f"batched create of {n}: {steps} steps, {counts}")
    # both packages take the same steps (the Twin held them to the same
    # acks at the same steps): more for the larger batch, but no more than
    # in proportion to the names
    (s64, c64), (s256, c256) = got[64], got[256]
    assert s64 < s256 <= 4 * s64, got
    assert c64 < c256, got


def test_lossy_migration_steps_equal_on_both_packages(monkeypatch):
    _set_class_attrs(monkeypatch, [
        ((j_cls, t_cls), "restart_period_s", 0.02)
        for j_cls, t_cls in (
            (j_rc.StartEpochTask, t_rc.StartEpochTask),
            (j_rc.StopEpochTask, t_rc.StopEpochTask),
            (j_rc.DropEpochTask, t_rc.DropEpochTask),
            (j_rc.EpochCommitTask, t_rc.EpochCommitTask),
            (j_rc.LateStartTask, t_rc.LateStartTask),
            (j_ar.WaitEpochFinalState, t_ar.WaitEpochFinalState),
        )
    ])
    t = _twin(monkeypatch, ar=(16, 8, 4, 4))
    try:
        for c in t.both():
            for rc in c.reconfigurators:
                rc.echo_probe_period_s = 0.0
        t.set_filter(lambda: (lambda rng: (lambda dst, kind, body: rng.rand() > 0.3))(
            np.random.RandomState(7)))
        steps = {}
        for what, kind, body, ack_kind, max_steps in (
            ("create", "create_service", {"name": "lossy", "actives": [0, 1, 2]},
             "create_ack", 60),
            ("migrate", "reconfigure", {"name": "lossy", "new_actives": [1, 2, 3]},
             "reconfigure_ack", 100),
        ):
            n0 = t.n_steps
            ack = None
            for _ in range(8):
                t.client_request(kind, dict(body))
                ack = t.wait_for(ack_kind, max_steps=max_steps)
                if ack is not None:
                    break
            assert ack and ack["ok"], (what, ack)
            steps[what] = t.n_steps - n0
            if what == "create":
                t.run_requests("lossy", ["a", "b", "c"], entry=1)
        # every step above was compared on both packages: the same acks at
        # the same steps; the migration's count under this seed and clock
        print(f"lossy migration: {steps}")
        assert 0 < steps["migrate"] <= 800, steps
    finally:
        t.close()
