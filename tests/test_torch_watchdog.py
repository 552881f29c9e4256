"""The port's tracing watchdog (``obs.watchdog``) against the JAX
package's, exactly.

Both packages' span tracers get the same span stream from one injected
clock, and both watchdogs the same ``poll_once(now_ns)`` calls: the
``warnings`` lists, the logged ``# watchdog:`` lines and the registry
counters must be equal.  The scenarios are those of
``tests/test_spans.py`` (``TestWatchdog``): the dispatch share, a share
not judged mid-chain, skipped windows accumulating into the judged one,
one stall an episode, no stall before the first launch, none while a
stream launch is in flight (and a wedged one still warning), none with a
drain heartbeat; and ``tests/test_capacity.py``'s watchdog without a
compile plane, and with one that holds no retrace.  The retrace-storm
rule is held against JAX's in ``tests/test_torch_programs.py``."""

import pytest

from dmclock_tpu.obs import compile_plane as jcp
from dmclock_tpu.obs import spans as jspans
from dmclock_tpu.obs.registry import MetricsRegistry as JRegistry
from dmclock_tpu.obs.watchdog import Watchdog as JWatchdog
from dmclock_tpu_torch.obs import compile_plane as tcp
from dmclock_tpu_torch.obs import spans as tspans
from dmclock_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from dmclock_tpu_torch.obs.watchdog import Watchdog as TWatchdog

MS = 1_000_000


class Pair:
    """One clock, both packages' tracer + watchdog + registry + log."""

    def __init__(self, **wd_kw):
        self.t = 0
        clock = self.clock
        self.logs = ([], [])
        self.regs = (JRegistry(), TRegistry())
        self.tracers = (jspans.SpanTracer(clock_ns=clock),
                        tspans.SpanTracer(clock_ns=clock))
        self.wds = tuple(
            cls(tr, registry=reg, log=logs.append, clock_ns=clock, **wd_kw)
            for cls, tr, reg, logs in zip((JWatchdog, TWatchdog),
                                          self.tracers, self.regs,
                                          self.logs))

    def clock(self):
        return self.t

    def span(self, name, cat, ns):
        for tr in self.tracers:
            sp = tr.span(name, cat)
            sp.__enter__()
        self.t += ns
        for tr in self.tracers:
            tr._stack()[-1].__exit__(None, None, None)

    def open(self, name, cat):
        return [tr.span(name, cat).__enter__() for tr in self.tracers]

    def instant(self, name, cat):
        for tr in self.tracers:
            tr.instant(name, cat)

    def poll(self, now=None):
        out = [wd.poll_once(now) for wd in self.wds]
        assert out[0] == out[1]
        return out[1]

    def check(self):
        j, t = self.wds
        assert j.warnings == t.warnings
        assert self.logs[0] == self.logs[1]
        assert self.regs[0].prometheus() == self.regs[1].prometheus()
        assert j.polls == t.polls
        return t.warnings


def test_dispatch_share_warning():
    p = Pair(dispatch_share_warn=0.5)
    for disp, dev, want in ((90, 10, ["dispatch_share"]), (90, 10, []),
                            (10, 90, []), (90, 10, ["dispatch_share"])):
        p.span("l", "dispatch", disp * MS)
        p.span("w", "device_compute", dev * MS)
        assert [w["kind"] for w in p.poll()] == want
    warns = p.check()
    assert len(warns) == 2 and warns[0]["share"] == pytest.approx(0.9)
    assert p.logs[1][0].startswith("# watchdog:")
    assert p.regs[1].counter("dmclock_watchdog_warnings_total").value == 2


def test_share_not_judged_mid_chain():
    p = Pair(dispatch_share_warn=0.5)
    p.span("l", "dispatch", 500 * MS)
    assert p.poll() == []
    p.span("l", "dispatch", 500 * MS)
    p.span("w", "device_compute", 100 * MS)
    assert [w["kind"] for w in p.poll()] == ["dispatch_share"]
    p.check()


def test_skipped_windows_accumulate_into_judged_one():
    p = Pair(dispatch_share_warn=0.6)
    for _ in range(3):
        p.span("l", "dispatch", 1000 * MS)
        assert p.poll() == []
    p.span("l", "dispatch", 500 * MS)
    p.span("w", "device_compute", 1000 * MS)
    (w,) = p.poll()
    assert w["share"] == pytest.approx(3.5 / 4.5, abs=1e-3)
    p.check()


def test_launch_stall_warns_once_per_episode():
    p = Pair(stall_after_s=1.0, dispatch_share_warn=2.0)
    p.span("l", "dispatch", 1 * MS)
    assert p.poll() == []
    p.t += 2000 * MS
    assert [w["kind"] for w in p.poll()] == ["launch_stall"]
    assert p.poll() == []
    p.span("l", "dispatch", 1 * MS)
    assert p.poll() == []
    p.t += 2000 * MS
    assert [w["kind"] for w in p.poll()] == ["launch_stall"]
    assert len(p.check()) == 2


def test_no_stall_before_first_launch():
    p = Pair(stall_after_s=1.0)
    p.t += 10_000 * MS
    assert p.poll() == []
    assert p.check() == []


def test_no_stall_while_stream_launch_in_flight():
    p = Pair(stall_after_s=1.0, dispatch_share_warn=2.0)
    p.span("stream.dispatch", "dispatch", 1 * MS)
    spans = p.open("stream.device_wait", "device_compute")
    p.t += 5000 * MS
    assert p.poll() == []
    for sp in spans:
        sp.__exit__(None, None, None)
    p.t += 5000 * MS
    assert [w["kind"] for w in p.poll()] == ["launch_stall"]
    p.check()


def test_wedged_launch_still_warns():
    p = Pair(stall_after_s=1.0, in_flight_max_s=8.0,
             dispatch_share_warn=2.0)
    p.span("stream.dispatch", "dispatch", 1 * MS)
    spans = p.open("stream.device_wait", "device_compute")
    p.t += 5000 * MS
    assert p.poll() == []
    p.t += 5000 * MS
    assert [w["kind"] for w in p.poll()] == ["launch_stall"]
    for sp in spans:
        sp.__exit__(None, None, None)
    p.check()


def test_no_stall_with_stream_heartbeat():
    p = Pair(stall_after_s=1.0, dispatch_share_warn=2.0)
    p.span("stream.dispatch", "dispatch", 1 * MS)
    for _ in range(5):
        p.t += 800 * MS
        p.instant("stream.drain", "drain")
        assert p.poll() == []
    p.t += 2000 * MS
    assert [w["kind"] for w in p.poll()] == ["launch_stall"]
    p.check()


def test_external_warning_and_explicit_now():
    p = Pair(stall_after_s=1.0)
    for wd in p.wds:
        wd.external_warning({"kind": "slo_resv_miss", "client": 3})
    p.span("l", "dispatch", 1 * MS)
    assert p.poll() == []
    assert [w["kind"] for w in p.poll(now=5000 * MS)] == ["launch_stall"]
    assert len(p.check()) == 2


def test_watchdog_without_plane_unaffected():
    jt, tt = jspans.SpanTracer(), tspans.SpanTracer()
    jw = JWatchdog(jt, log=lambda _l: None)
    tw = TWatchdog(tt, log=lambda _l: None)
    assert tw.poll_once() == jw.poll_once() == []
    # a plane without retraces attached: nothing to warn about either
    jw = JWatchdog(jt, compile_plane=jcp.CompilePlane(),
                   log=lambda _l: None)
    tw = TWatchdog(tt, compile_plane=tcp.CompilePlane(),
                   log=lambda _l: None)
    assert tw.poll_once() == jw.poll_once() == []


def test_thread_polls_and_closes():
    tr = tspans.SpanTracer()
    reg = TRegistry()
    with TWatchdog(tr, interval_s=0.01, registry=reg,
                   log=lambda _l: None) as wd:
        with tr.span("l", "dispatch"):
            pass
        import time
        deadline = time.monotonic() + 5
        while wd.polls < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert wd.polls >= 3 and wd.poll_errors == 0
    assert wd._thread is None
