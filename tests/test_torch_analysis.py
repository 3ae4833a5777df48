"""The port's ctpulint (cassandra_tpu_torch/analysis/) and its runtime
LockWitness (cassandra_tpu_torch/utils/lockwitness.py).

The fixture tests of tests/test_static_analysis.py, run through the
port's checks; the same `from_sources` fixtures given to the JAX
package's checks and the port's, which must report the same violations
apart from the package prefix; and the port's real tree, which must be
clean, with every suppression reasoned and used, and with every check's
root present."""
import subprocess
import sys
import threading

import pytest

from cassandra_tpu.analysis import checks as jchecks
from cassandra_tpu.analysis.walker import ProjectIndex as JIndex
from cassandra_tpu_torch.analysis import checks
from cassandra_tpu_torch.analysis.__main__ import run_ast_checks
from cassandra_tpu_torch.analysis.report import (Violation,
                                                 apply_suppressions,
                                                 parse_suppressions,
                                                 reasonless)
from cassandra_tpu_torch.analysis.walker import REPO, ProjectIndex
from cassandra_tpu_torch.utils import lockwitness
from torch_tmp import tmp_path  # noqa: F401

# the roots whose modules the port does not hold: none since the
# networked stack and the simulator landed, so the real tree must report
# every check's root present
ABSENT_ROOTS = set()


@pytest.fixture(autouse=True)
def _witness_clean():
    """Every test starts disarmed with an empty order graph."""
    lockwitness.disarm()
    lockwitness.reset()
    yield
    lockwitness.disarm()
    lockwitness.reset()


# ------------------------------------------------------------ fixtures --

AB_BA = '''
import threading


class Box:
    def __init__(self):
        self._la = threading.Lock()
        self._lb = threading.Lock()

    def ab(self):
        with self._la:
            with self._lb:
                pass

    def ba(self):
        with self._lb:
            with self._la:
                pass
'''

INTERPROCEDURAL = '''
import threading


class Box:
    def __init__(self):
        self._la = threading.Lock()
        self._lb = threading.Lock()

    def take_b(self):
        with self._lb:
            pass

    def ab(self):
        with self._la:
            self.take_b()

    def ba(self):
        with self._lb:
            with self._la:
                pass
'''

ORDERED = AB_BA.replace("with self._lb:\n            with self._la:",
                        "with self._la:\n            with self._lb:")

ALLOWED_EDGE = AB_BA.replace(
    "        with self._lb:\n            with self._la:",
    "        with self._lb:\n"
    "            # ctpulint: allow(lock-order, reason=ba only runs "
    "single-threaded at boot)\n"
    "            with self._la:")

KNOB_FIXTURE = '''
from dataclasses import dataclass, field


def mut(default):
    return field(default=default, metadata={"mutable": True})


def spec(kind, default, mutable=False):
    return field(default=default,
                 metadata={"spec": kind, "mutable": mutable})


@dataclass
class Config:
    wired_knob: int = mut(3)
    unwired_knob: int = mut(7)
    immutable_thing: int = spec("storage", 1)
'''

KNOB_CONSUMER = '''
def hook(settings):
    settings.on_change("wired_knob", lambda v: v)
'''

KNOB_REREAD = "def use(cfg):\n    return cfg.unwired_knob\n"

# a tools module naming a knob wires nothing (nodetool's side door)
KNOB_TOOL = 'def setter(s):\n    s.set("unwired_knob", 1)\n'

WORKER_BAD = '''
import threading


class W:
    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            self.work()

    def work(self):
        raise RuntimeError("boom")
'''

WORKER_GOOD = WORKER_BAD.replace(
    "        while True:\n            self.work()",
    "        while True:\n"
    "            try:\n"
    "                self.work()\n"
    "            except Exception:\n"
    "                pass")

WORKER_RERAISE = WORKER_BAD.replace(
    "        while True:\n            self.work()",
    "        while True:\n"
    "            try:\n"
    "                self.work()\n"
    "            except Exception:\n"
    "                raise")

CLOCKY = ("# ctpulint: clock-injectable\n"
          "import time\n\n\n"
          "def bad():\n"
          "    return time.monotonic()\n\n\n"
          "def ok(clock=time.monotonic):   # the seam itself\n"
          "    return clock()\n")

SCHED = '_PATCH_MODULES = ("fix.simmod",)\n'
SIMMOD = ("import time\n"
          "import time as _t\n"
          "from time import sleep\n\n\n"
          "def f(clock=time.monotonic):\n"
          "    return time.monotonic()\n")

SERVER = '''
import time


class Helper:
    def slow(self):
        time.sleep(1.0)


class _EventLoop:
    def __init__(self, helper: "Helper"):
        self.helper = helper

    def run(self):
        while True:
            self._on_ready()

    def _on_ready(self):
        self.helper.slow()
'''

GOSSIP = '''
import threading
import time


class Gossiper:
    def __init__(self):
        self._lock = threading.Lock()

    def tick(self):
        with self._lock:
            time.sleep(0.1)
            self._apply()

    def _apply(self):
        self._cond.wait()
'''

# a required clock seam without its marker
TIMEUTIL_UNMARKED = "import time\nCLOCK = time.time\n"

# (fixture name, {relpath: source}; "{pkg}" stands for the package,
# check name or None for all five, kwargs of that check's run)
FIXTURES = [
    ("ab-ba", {"fix/mod.py": AB_BA}, "lock-order", {}),
    ("interprocedural", {"fix/mod.py": INTERPROCEDURAL}, "lock-order", {}),
    ("ordered", {"fix/mod.py": ORDERED}, "lock-order", {}),
    ("allowed-edge", {"fix/mod.py": ALLOWED_EDGE}, None, {}),
    ("knob-unwired", {"fix/config.py": KNOB_FIXTURE,
                      "fix/consumer.py": KNOB_CONSUMER}, "knob-wiring",
     {"config_mod": "fix.config"}),
    ("knob-reread", {"fix/config.py": KNOB_FIXTURE,
                     "fix/consumer.py": KNOB_REREAD,
                     "fix/consumer2.py": KNOB_CONSUMER}, "knob-wiring",
     {"config_mod": "fix.config"}),
    ("knob-package", {"{pkg}/config.py": KNOB_FIXTURE,
                      "{pkg}/tools/nodetool.py": KNOB_TOOL,
                      "{pkg}/service/hooks.py": KNOB_CONSUMER}, None, {}),
    ("worker-bad", {"fix/w.py": WORKER_BAD}, "worker-loops", {}),
    ("worker-good", {"fix/w.py": WORKER_GOOD}, "worker-loops", {}),
    ("worker-reraise", {"fix/w.py": WORKER_RERAISE}, "worker-loops", {}),
    ("clock-marked", {"fix/clocky.py": CLOCKY}, None, {}),
    ("clock-sim", {"{pkg}/sim/scheduler.py": SCHED,
                   "fix/simmod.py": SIMMOD}, None, {}),
    ("clock-unmarked", {"{pkg}/utils/timeutil.py": TIMEUTIL_UNMARKED},
     None, {}),
    ("loop-server", {"{pkg}/transport/server.py": SERVER}, None, {}),
    ("loop-gossip", {"{pkg}/cluster/gossip.py": GOSSIP}, None, {}),
]


def _index(index_cls, sources: dict, pkg: str):
    return index_cls.from_sources({rel.replace("{pkg}", pkg): text
                                   for rel, text in sources.items()})


def _run(checks_mod, idx, check, kw) -> list:
    if check is None:
        return checks_mod.run_all(idx)
    return checks_mod.CHECKS[check][0].run(idx, **kw)


def _port(sources: dict, check=None, **kw) -> tuple:
    idx = _index(ProjectIndex, sources, "cassandra_tpu_torch")
    return idx, _run(checks, idx, check, kw)


# ------------------------------------------------------------ lock-order --

def test_lock_order_detects_ab_ba_cycle():
    _idx, vs = _port({"fix/mod.py": AB_BA}, "lock-order")
    assert len(vs) == 1
    assert "cycle" in vs[0].message
    assert "Box._la" in vs[0].message and "Box._lb" in vs[0].message


def test_lock_order_interprocedural_cycle():
    """ab holds A and CALLS a helper that takes B; ba nests the other
    way — the edge must come through the call graph."""
    _idx, vs = _port({"fix/mod.py": INTERPROCEDURAL}, "lock-order")
    assert len(vs) == 1, [str(v) for v in vs]


def test_lock_order_ordered_nesting_is_clean():
    assert _port({"fix/mod.py": ORDERED}, "lock-order")[1] == []


def test_lock_order_allowlisted_edge_with_reason_is_dropped():
    idx, vs = _port({"fix/mod.py": ALLOWED_EDGE}, "lock-order")
    assert vs == []
    # and the suppression is marked used (surfaced by --explain)
    assert any(s.used for s in idx.suppressions())


# ----------------------------------------------------------- LockWitness --

def test_witness_ab_ba_raises_with_both_stacks():
    lockwitness.arm()
    la = lockwitness.make_lock("fix.la")
    lb = lockwitness.make_lock("fix.lb")
    with la:
        with lb:
            pass
    with pytest.raises(lockwitness.LockOrderError) as ei:
        with lb:
            with la:
                pass
    msg = str(ei.value)
    assert "fix.la" in msg and "fix.lb" in msg
    assert "this acquisition" in msg
    assert "recorded 'fix.la' -> 'fix.lb'" in msg
    assert msg.count("test_witness_ab_ba_raises_with_both_stacks") >= 2


def test_witness_cross_thread_cycle_detected():
    """Thread 1 records A->B; the main thread closing B->A raises even
    though neither thread ever deadlocked."""
    lockwitness.arm()
    la = lockwitness.make_lock("fix.t.la")
    lb = lockwitness.make_lock("fix.t.lb")

    def t1():
        with la:
            with lb:
                pass

    th = threading.Thread(target=t1)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    with pytest.raises(lockwitness.LockOrderError):
        with lb:
            with la:
                pass


def test_witness_reentrant_and_condition_wait():
    lockwitness.arm()
    rl = lockwitness.make_rlock("fix.re")
    with rl:
        with rl:          # re-entrancy adds no edge, no raise
            pass
    cond = lockwitness.make_condition("fix.cond")
    other = lockwitness.make_lock("fix.other")
    hit = []

    def notifier():
        # takes `other` WITHOUT holding the condition lock: must not
        # record cond->other (wait released it)
        with other:
            hit.append(1)
        with cond:
            cond.notify_all()

    with cond:
        th = threading.Thread(target=notifier)
        th.start()
        assert cond.wait(timeout=5.0)
        th.join(timeout=10)
    assert not th.is_alive()
    assert hit == [1]
    assert "fix.other" not in lockwitness.graph_snapshot().get(
        "fix.cond", [])


def test_witness_disarmed_is_raw_primitives():
    lk = lockwitness.make_lock("fix.raw")
    assert type(lk) is type(threading.Lock())
    rk = lockwitness.make_rlock("fix.raw.r")
    assert type(rk) is type(threading.RLock())


# ----------------------------------------------------------- suppression --

def test_suppression_without_reason_rejected():
    src = "x = 1  # ctpulint: allow(lock-order)\n"
    supps = parse_suppressions("fix/mod.py", src)
    assert len(supps) == 1 and supps[0].reason is None
    metas = reasonless(supps)
    assert len(metas) == 1
    assert metas[0].check == "suppression"
    # and a reasonless allow suppresses NOTHING
    v = Violation("lock-order", "fix/mod.py", 1, "boom")
    assert apply_suppressions([v], supps) == [v]


def test_suppression_with_reason_covers_same_and_previous_line():
    src = ("# ctpulint: allow(worker-loops, reason=loop exits into the "
           "io_error funnel)\nwhile True: pass\n")
    supps = parse_suppressions("fix/mod.py", src)
    v = Violation("worker-loops", "fix/mod.py", 2, "boom")
    assert apply_suppressions([v], supps) == []
    assert v.suppressed_by is supps[0]


# ----------------------------------------------------------- knob-wiring --

def test_knob_wiring_catches_unwired_mutable_fixture():
    _idx, vs = _port({"fix/config.py": KNOB_FIXTURE,
                      "fix/consumer.py": KNOB_CONSUMER}, "knob-wiring",
                     config_mod="fix.config")
    assert [v for v in vs if "`unwired_knob`" in v.message]
    assert not [v for v in vs if "`wired_knob`" in v.message]
    assert not [v for v in vs if "immutable_thing" in v.message]


def test_knob_wiring_attribute_reread_counts():
    _idx, vs = _port({"fix/config.py": KNOB_FIXTURE,
                      "fix/consumer.py": KNOB_REREAD,
                      "fix/consumer2.py": KNOB_CONSUMER}, "knob-wiring",
                     config_mod="fix.config")
    assert vs == []


def test_knob_wiring_port_tools_are_no_wiring():
    """The default config module is the port's; its tools/ naming a
    knob (nodetool's settings side door) wires nothing."""
    _idx, vs = _port({"cassandra_tpu_torch/config.py": KNOB_FIXTURE,
                      "cassandra_tpu_torch/tools/nodetool.py": KNOB_TOOL,
                      "cassandra_tpu_torch/service/hooks.py":
                      KNOB_CONSUMER}, "knob-wiring")
    assert [v.message.split("`")[1] for v in vs] == ["unwired_knob"]
    assert vs[0].path == "cassandra_tpu_torch/config.py"


# ---------------------------------------------------------- worker-loops --

def test_worker_loops_unguarded_daemon_flagged_guarded_clean():
    vs = _port({"fix/w.py": WORKER_BAD}, "worker-loops")[1]
    assert len(vs) == 1 and "die silently" in vs[0].message
    assert _port({"fix/w.py": WORKER_GOOD}, "worker-loops")[1] == []


def test_worker_loops_bare_reraise_is_not_a_guard():
    assert len(_port({"fix/w.py": WORKER_RERAISE}, "worker-loops")[1]) == 1


# ------------------------------------------------------ clock-discipline --

def test_clock_discipline_marked_module_direct_call_flagged():
    vs = _port({"fix/clocky.py": CLOCKY}, "clock-discipline")[1]
    assert len(vs) == 1
    assert vs[0].line == 6


def test_clock_discipline_sim_patched_rules():
    """Fixture planted AT the port's sim-module path: aliased import +
    from-import + def-time default all flagged."""
    idx, vs = _port({"cassandra_tpu_torch/sim/scheduler.py": SCHED,
                     "fix/simmod.py": SIMMOD}, "clock-discipline")
    msgs = "\n".join(v.message for v in vs)
    assert "import time as _t" in msgs
    assert "from time import" in msgs
    assert "default argument" in msgs
    # the module-attribute call time.monotonic() inside the body is
    # FINE in a sim-patched module (the simulator patches the attr)
    assert len(vs) == 3
    assert "cassandra_tpu_torch.sim.scheduler" not in idx.absent_roots


def test_clock_discipline_required_marker():
    vs = _port({"cassandra_tpu_torch/utils/timeutil.py":
                TIMEUTIL_UNMARKED}, "clock-discipline")[1]
    assert len(vs) == 1 and "must declare" in vs[0].message
    assert vs[0].path == "cassandra_tpu_torch/utils/timeutil.py"


# --------------------------------------------------------- loop-blocking --

def test_loop_blocking_fixture_reachable_sleep_flagged():
    idx, vs = _port({"cassandra_tpu_torch/transport/server.py": SERVER},
                    "loop-blocking")
    assert len(vs) == 1
    assert "sleep" in vs[0].message
    assert "_EventLoop.run" in vs[0].message     # the chain is printed
    assert idx.absent_roots == {"cassandra_tpu_torch.cluster.gossip"}


def test_loop_blocking_under_gossip_lock_flagged():
    idx, vs = _port({"cassandra_tpu_torch/cluster/gossip.py": GOSSIP},
                    "loop-blocking")
    whys = sorted(v.message.split(" (")[0] for v in vs)
    assert whys == ["condition/event wait", "sleep"]
    assert idx.absent_roots == {"cassandra_tpu_torch.transport.server"}


# ------------------------------------------- the same as the JAX package --

def _normal(vs: list, pkg: str) -> list:
    return sorted((v.check, v.path.replace(pkg, "{pkg}"), v.line,
                   v.message.replace(pkg, "{pkg}")) for v in vs)


@pytest.mark.parametrize("name,sources,check,kw", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_same_violations_as_jax(name, sources, check, kw):
    """The same fixture through the JAX package's checks (planted under
    cassandra_tpu/) and the port's (under cassandra_tpu_torch/): the
    same violations at the same lines, apart from the prefix."""
    jidx = _index(JIndex, sources, "cassandra_tpu")
    tidx = _index(ProjectIndex, sources, "cassandra_tpu_torch")
    jv = _normal(_run(jchecks, jidx, check, kw), "cassandra_tpu")
    tv = _normal(_run(checks, tidx, check, kw), "cassandra_tpu_torch")
    assert tv == jv
    assert [s.used for s in tidx.suppressions()] == \
        [s.used for s in jidx.suppressions()]
    if name not in ("ordered", "allowed-edge", "worker-good",
                    "knob-reread"):
        assert tv, "the fixture must give a violation"


# --------------------------------------------------------- the real tree --

def test_real_tree_is_clean_and_allowlist_reasoned_and_used():
    """The port's tree passes all five checks; every suppression carries
    a reason and still names a line that needs it; the checks whose
    root is not ported yet say so, and the set of such roots is exactly
    ABSENT_ROOTS."""
    idx = ProjectIndex.build()
    assert "cassandra_tpu_torch.parallel.mesh" in idx.modules
    assert "chip_smoke" in idx.modules and "kernel_ab" in idx.modules
    assert not any(m.startswith("cassandra_tpu.") for m in idx.modules)
    violations = checks.run_all(idx)
    supps = idx.suppressions()
    remaining = apply_suppressions(violations, supps) + reasonless(supps)
    assert remaining == [], "\n".join(str(v) for v in remaining)
    for s in supps:
        assert s.reason and len(s.reason) > 10, str(s)
        assert s.used, f"stale suppression: {s}"
    assert {m[len("cassandra_tpu_torch."):]
            for m in idx.absent_roots} == ABSENT_ROOTS
    assert all(m.startswith("cassandra_tpu_torch.")
               for m in idx.absent_roots)


def test_real_tree_witness_locks_declared():
    """The walker sees lockwitness factory calls as lock declarations
    (so converted modules keep participating in the static pass)."""
    idx = ProjectIndex.build()
    table = idx.modules["cassandra_tpu_torch.storage.table"]
    assert table.classes["WriteBarrier"].lock_attrs.get("_cond") \
        == "condition"
    cl = idx.modules["cassandra_tpu_torch.storage.commitlog"]
    assert cl.classes["CommitLog"].lock_attrs.get("_sync_cond") \
        == "condition"
    # the port's own locks: the launch counters and the profiling
    # registry take part in the lock graph
    lib = idx.modules["cassandra_tpu_torch.ops.cuda_lib"]
    assert lib.global_locks.get("_count_lock") == "lock"
    prof = idx.modules["cassandra_tpu_torch.service.profiling"]
    assert prof.classes["DeviceProgramRegistry"].lock_attrs.get(
        "_lock") == "lock"


def test_entry_point_exit_codes(capsys):
    """run_ast_checks exits 0 on the port's tree and 1 on a fixture with a
    lock-order cycle; absent roots are printed, not passed over."""
    assert run_ast_checks(index=ProjectIndex.build()) == 0
    out = capsys.readouterr().out
    assert "0 violations" in out
    assert "roots not in the tree" not in out   # every root is ported
    # a tree without the checks' roots names them in its note
    assert run_ast_checks(index=ProjectIndex.from_sources(
        {"fix/mod.py": "X = 1\n"})) == 0
    out = capsys.readouterr().out
    assert "roots not in the tree" in out
    assert "cassandra_tpu_torch.transport.server" in out
    assert run_ast_checks(index=ProjectIndex.from_sources(
        {"fix/mod.py": AB_BA})) == 1
    assert "lock-order cycle" in capsys.readouterr().err


def test_module_entry_point():
    """`python -m cassandra_tpu_torch.analysis` imports no jax and exits
    0 on the tree; --list prints the five checks."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.argv = ['x'] + sys.argv[1:]; "
            "runpy.run_module('cassandra_tpu_torch.analysis', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ctpulint OK" in out.stdout
    out = subprocess.run([sys.executable, "-c", code, "--list"], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    assert sorted(line.split()[0] for line in out.stdout.splitlines()) == \
        sorted(checks.CHECKS)


# ------------------------------------------- faults repaired in the port --

class _FakeEvent:
    """A completed CUDA event whose wait runs `on_wait` first."""

    def __init__(self, on_wait=None):
        self.on_wait = on_wait

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        if self.on_wait is not None:
            self.on_wait()


def test_sort_passes_do_not_leak_across_a_reset():
    """A fold takes the pending sorts under the counters' lock and reads
    them outside it; a reset_launches() in between (another thread's
    leg boundary) must not see the earlier sorts' passes added to the
    new counts."""
    import torch

    from cassandra_tpu_torch.ops import cuda_lib

    name = "merge.sort_perm"
    cuda_lib.reset_launches()
    try:
        cuda_lib._PENDING[name].append(
            (torch.tensor([5], dtype=torch.int32),
             _FakeEvent(on_wait=cuda_lib.reset_launches)))
        assert cuda_lib.passes()[name] == 0
        cuda_lib._PENDING[name].append(
            (torch.tensor([7], dtype=torch.int32), _FakeEvent()))
        assert cuda_lib.passes()[name] == 7
    finally:
        cuda_lib.reset_launches()


# ------------------------------------------------ the witness under sim --

def test_witness_under_sim_deterministic(tmp_path):
    """tests/test_static_analysis.py's counterpart: the armed witness
    inside the port's simulated(seed): same seed -> identical event
    trace, no witness raise, armed state restored after."""
    from cassandra_tpu_torch.sim.scheduler import SimCluster, simulated

    traces = []
    for run in range(2):
        with simulated(seed=1234) as sched:
            assert lockwitness.armed()
            cluster = SimCluster(sched, str(tmp_path / f"r{run}"), n=2,
                                 gossip_interval=0.25, device="cpu")
            sched.run(3.0)
            traces.append(list(sched.trace))
            cluster.shutdown()
        assert not lockwitness.armed()
        lockwitness.reset()
    assert traces[0] and traces[0] == traces[1]
