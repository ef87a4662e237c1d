"""The config/flag system, the profiler, the disk map and the RTT
redirector on both packages: ``tests/test_utils.py`` run on the JAX
package and on the port (``device="cpu"`` where an engine runs).

Each scenario runs once per package and yields what it read (flag values
through the three tiers, parsed properties, profiler stats, the manager's
and failure detector's settings, the disk map's tiers and contents, the
redirector's picks); the two must be equal, and the reference's own
assertions hold on each.  The flag-hygiene scan reads each package's own
sources.
"""

import enum
import pathlib

import pytest

from torch_pkgs import JAX, PKGS, TORCH

REPO = pathlib.Path(__file__).resolve().parent.parent


class Flags(enum.Enum):
    ALPHA = 42
    BETA = True
    GAMMA = "hello"
    DELTA = 1.5


for _pkg in PKGS:
    _pkg.mod("utils.config").Config.register(Flags)


@pytest.fixture(autouse=True)
def _clear_config():
    yield
    for pkg in PKGS:
        pkg.mod("utils.config").Config.clear()


def both(fn, *a):
    ref, port = fn(JAX, *a), fn(TORCH, *a)
    assert port == ref
    return port


def _cfg(pkg):
    return pkg.mod("utils.config").Config


def defaults(pkg):
    Config = _cfg(pkg)
    out = [Config.get(Flags.ALPHA), Config.get_bool(Flags.BETA),
           Config.get_str(Flags.GAMMA), Config.get_float(Flags.DELTA)]
    assert out == [42, True, "hello", 1.5]
    return out


def test_defaults():
    both(defaults)


def three_tiers(pkg, tmp_path):
    Config = _cfg(pkg)
    p = tmp_path / f"{pkg}.properties"
    p.write_text("ALPHA=7\nBETA=false\n# comment\nactive.AR0=1.2.3.4:2000\n")
    Config.load_file(str(p))
    out = [Config.get_int(Flags.ALPHA), Config.get_bool(Flags.BETA)]
    assert out == [7, False]                         # file beats default
    rest = Config.register_args(["ALPHA=9", "positional", "-x"])
    assert rest == ("positional", "-x")
    assert Config.get_int(Flags.ALPHA) == 9          # CLI beats file
    assert Config.node_addresses("active") == {"AR0": ("1.2.3.4", 2000)}
    out += [rest, Config.get_int(Flags.ALPHA), Config.node_addresses("active")]
    Config.clear()
    return out


def test_three_tiers(tmp_path):
    both(three_tiers, tmp_path)


def parse(pkg):
    props = pkg.mod("utils.config").parse_properties("a=1\nb: two\n!ignored\n\nc = 3 ")
    assert props == {"a": "1", "b": "two", "c": "3"}
    return props


def test_parse_properties():
    both(parse)


def profiler(pkg):
    DelayProfiler = pkg.mod("utils.profiler").DelayProfiler
    DelayProfiler.clear()
    DelayProfiler.update_mov_avg("lat", 1.0)
    DelayProfiler.update_count("reqs", 5)
    assert DelayProfiler.get("lat") == 1.0
    assert DelayProfiler.get("reqs") == 5
    stats = DelayProfiler.get_stats()
    assert "lat" in stats
    DelayProfiler.clear()
    return stats


def test_profiler():
    both(profiler)


def flags_reach(pkg, tmp_path):
    Config = _cfg(pkg)
    props = tmp_path / f"{pkg}.gigapaxos.properties"
    props.write_text("CHECKPOINT_INTERVAL=7\nJUMP_HORIZON_WINDOWS=2\n"
                     "FAILURE_DETECTION_TIMEOUT_S=1.5\nREQUEST_TIMEOUT_S=3.0\n"
                     "RC.DEFAULT_NUM_REPLICAS=5\n")
    Config.clear()
    try:
        Config.load_file(str(props))
        cfg = pkg.mod("ops.engine").EngineConfig(n_groups=4, window=8, req_lanes=4,
                                                 n_replicas=3)
        PaxosManager = pkg.mod("manager").PaxosManager
        Noop = pkg.mod("models").NoopPaxosApp
        m = PaxosManager(0, Noop(), cfg, **pkg.dev)
        assert m.checkpoint_every == 7
        assert m.jump_horizon == 2 * 8
        assert m.outstanding.timeout_s == 3.0
        fd = pkg.mod("failure_detection").FailureDetector(0, [0, 1, 2])
        assert fd.timeout_s == 1.5
        RC = pkg.mod("reconfiguration.rc_config").RC
        assert Config.get_int(RC.DEFAULT_NUM_REPLICAS) == 5
        Config.register_args(["CHECKPOINT_INTERVAL=11"])
        m2 = PaxosManager(1, Noop(), cfg, **pkg.dev)
        assert m2.checkpoint_every == 11
        return [m.checkpoint_every, m.jump_horizon, m.outstanding.timeout_s,
                fd.timeout_s, Config.get_int(RC.DEFAULT_NUM_REPLICAS),
                m2.checkpoint_every]
    finally:
        Config.clear()


def test_flags_reach_the_framework(tmp_path):
    both(flags_reach, tmp_path)


def no_aliasing(pkg):
    PC = pkg.mod("paxos_config").PC
    RC = pkg.mod("reconfiguration.rc_config").RC
    config = pkg.mod("utils.config")
    Config = config.Config
    for enum_cls in (PC, RC):
        members = dict(enum_cls.__members__.items())
        assert len(set(members.values())) == len(members), \
            "aliased flags in " + enum_cls.__name__
    Config.clear()
    try:
        Config.set("BATCHING_ENABLED", "false")
        out = [Config.get_bool(PC.ENABLE_JOURNALING), Config.get_bool(PC.PAUSE_OPTION),
               Config.get_bool(PC.BATCHING_ENABLED)]
        assert out == [True, True, False]
        Config.set("ENGINE_ROWS", "128")
        assert Config.get_int(PC.RESPONSE_CACHE_SIZE) == \
            config.flag_default(PC.RESPONSE_CACHE_SIZE)
        return out
    finally:
        Config.clear()


def test_no_flag_aliasing():
    both(no_aliasing)


def flag_defaults(pkg):
    """Every flag's default, a dotted class path naming the package's own
    module read with the package's name taken out."""
    config = pkg.mod("utils.config")
    own = lambda v: v.replace(pkg.root + ".", "<pkg>.") if isinstance(v, str) else v
    return {e.__name__: {n: own(config.flag_default(m)) for n, m in e.__members__.items()}
            for e in (pkg.mod("paxos_config").PC, pkg.mod("reconfiguration.rc_config").RC)}


def test_flags_and_defaults_equal_the_reference():
    """The two packages register the same flags with the same defaults,
    and the port one more: DEVICE (the engine's device, unset = the card;
    ROADMAP §C, "Port-only fields and ops")."""
    ref, port = flag_defaults(JAX), flag_defaults(TORCH)
    assert port["PC"].pop("DEVICE") == ""
    assert port == ref


@pytest.mark.parametrize("pkg", PKGS, ids=str)
def test_every_registered_flag_is_read_somewhere(pkg):
    """Every PC/RC member is consumed by a source file of the package
    outside its defining module (PaxosConfig.java:214-967)."""
    PC = pkg.mod("paxos_config").PC
    RC = pkg.mod("reconfiguration.rc_config").RC
    sources = {str(p): p.read_text(encoding="utf-8")
               for p in (REPO / pkg.root).rglob("*.py")}
    unread = []
    for enum_cls, defining in ((PC, "paxos_config.py"), (RC, "rc_config.py")):
        for member in enum_cls:
            token = f"{enum_cls.__name__}.{member.name}"
            if not any(token in text for path, text in sources.items()
                       if not path.endswith(defining)):
                unread.append(token)
    assert not unread, f"decorative flags with no read site: {unread}"


def diskmap(pkg, tmp_path):
    dm = pkg.mod("utils.diskmap").DiskMap(str(tmp_path / f"{pkg}-dm"), capacity=8)
    for i in range(20):
        dm[("k", i)] = {"v": i}
    assert len(dm) == 20
    assert dm.n_in_memory <= 8 and dm.n_on_disk >= 12
    tiers = (dm.n_in_memory, dm.n_on_disk)
    for i in range(20):
        assert dm[("k", i)] == {"v": i}
    del dm[("k", 3)]
    assert ("k", 3) not in dm and len(dm) == 19
    dm[("k", 5)] = {"v": 500}
    assert dm[("k", 5)] == {"v": 500}
    assert set(dm) == {("k", i) for i in range(20) if i != 3}
    return [tiers, sorted((k, dm[k]["v"]) for k in dm), len(dm)]


def test_diskmap_spills_and_restores(tmp_path):
    both(diskmap, tmp_path)


def redirector(pkg):
    rd = pkg.mod("net.rtt").LatencyAwareRedirector()
    rd.PROBE_RATIO = 0.0  # deterministic for the test
    for _ in range(20):
        rd.record(0, 0.100)
        rd.record(1, 0.005)
        rd.record(2, 0.050)
    out = [rd.pick([0, 1, 2]), rd.pick([0, 1, 7])]
    assert out == [1, 7]
    return out


def test_rtt_redirector_prefers_fast_server():
    both(redirector)


def seeding(pkg):
    Redirector = pkg.mod("net.rtt").LatencyAwareRedirector
    rd = Redirector()
    rd.PROBE_RATIO = 0.0
    assert rd.seed(2, 0.003) and rd.seed(0, 0.050) and rd.seed(1, 0.020)
    out = [rd.pick([0, 1, 2])]
    assert out[0] == 2
    for _ in range(50):
        rd.record(2, 0.200)
    assert rd.seed(2, 0.003) is False
    out.append(rd.pick([0, 1, 2]))
    assert out[1] == 1
    rd2 = Redirector()
    rd2.PROBE_RATIO = 0.0
    for k in (3, 1, 2):
        rd2.seed(k, 0.010)
    ties = [rd2.pick([3, 1, 2]) for _ in range(10)]
    assert all(p == 1 for p in ties)
    return out + ties


def test_rtt_redirector_seeding_and_deterministic_ties():
    both(seeding)
