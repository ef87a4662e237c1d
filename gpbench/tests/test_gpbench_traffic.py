"""The traffic mixes draw everything they offer from the seed: the same
seed gives the same inputs, another seed other ones."""

import json
import os
import time

import numpy as np
import torch

from gpbench import load
from gpbench.loads import packed_host, stacked
from gpbench.system import Port

from .conftest import ROOT, TINY


def _mix(name):
    with open(os.path.join(ROOT, "gpbench", "traffic", name + ".json")) as f:
        return json.load(f)


def _stacked(seed, traffic="failover"):
    d = stacked.Load(TINY["configs"]["tiny_node"], _mix(traffic), seed,
                           Port("cpu"), load.Spans())
    d.setup()
    groups = torch.arange(d.G)
    rids = torch.arange(d.R)
    wants = torch.stack([d.want(t, groups, rids) for t in range(40)])
    return d.base.clone(), d.sample.copy(), wants


def test_stacked_inputs_follow_the_seed():
    a, b, c = _stacked(2 ** 31 + 7), _stacked(2 ** 31 + 7), _stacked(2 ** 31 + 8)
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert torch.equal(a[2], b[2])
    assert not torch.equal(a[0], c[0])
    assert int(a[0].min()) >= 1 and int(a[0].max()) < load.VID_SPAN
    # every request value a step offers differs from the step before's
    assert stacked.Load.offset(1) != stacked.Load.offset(0)


def _packed(seed):
    d = packed_host.Load(TINY["configs"]["tiny_ar"], dict(_mix("wire"), rate_per_s=3000),
                          seed, Port("cpu"), load.Spans())
    d.setup()
    return d.perm.copy(), d.sample.copy(), d.vid0, d.p_count[:d.n_props].copy()


def _schedule(seed, n=2000):
    """The first ``n`` arrivals of the schedule: offsets from the load's
    start, and keys."""
    d = packed_host.Load(TINY["configs"]["tiny_ar"], dict(_mix("wire"), rate_per_s=3000),
                          seed, Port("cpu"), load.Spans())
    d.sched_t, d.sched_k, d.sched_at = np.array([100.0]), np.zeros(1, np.int64), 1
    t, k = [], []
    while sum(map(len, t)) < n:
        tt, kk = d._due(d.sched_t[-1])
        t.append(tt)
        k.append(kk)
    return np.concatenate(t)[:n] - 100.0, np.concatenate(k)[:n]


def test_packed_inputs_follow_the_seed():
    a, b, c = _packed(5_000_000_001), _packed(5_000_000_001), _packed(5_000_000_002)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    # proposals coalesce a name's requests of one tick, at most
    # max_batch_size each
    assert a[3].max() <= TINY["configs"]["tiny_ar"]["max_batch_size"]
    sa, sb, sc = _schedule(7), _schedule(7), _schedule(8)
    assert np.array_equal(sa[0], sb[0]) and np.array_equal(sa[1], sb[1])
    assert not np.array_equal(sa[0], sc[0]) and not np.array_equal(sa[1], sc[1])
    # a Poisson stream at the mix's rate
    assert 0.9 * 2000 / 3000 < sa[0][-1] < 1.1 * 2000 / 3000


def test_the_in_flight_limit_holds_requests_at_their_clients():
    """With room for 40 undecided requests, the rest wait at their clients
    and are decided later, all of them."""
    conf = TINY["configs"]["tiny_capped"]
    mix = dict(_mix("wire"), rate_per_s=1500, drain_ticks=400)
    d = packed_host.Load(conf, mix, 11, Port("cpu"), load.Spans())
    d.setup()
    d.open_window(time.perf_counter())
    for _ in range(3):
        d.chunk()
    d.close_window(time.perf_counter())
    d.finish()
    assert max(d.outstanding) <= conf["max_outstanding_requests"]
    assert max(d.waiting) > 0 and d.capped_ticks > 0
    assert d.lost == 0 and d.wrong == 0, d.diagnostics()
