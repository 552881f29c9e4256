"""The port's metrics registry, its HTTP endpoint and the burn-rate
evaluator against the JAX package's (``obs/registry.py``,
``utils/profile.py``, ``obs/alerts.py``).

The same registrations give byte-equal Prometheus exposition and equal
snapshots; the same requests to the two endpoints (real sockets on
127.0.0.1) give equal answers; the same closed windows give the two
evaluators equal verdicts, summaries and encodings.
"""

import json
import types
import urllib.error
import urllib.request
from collections import deque

import numpy as np
import pytest

import dmclock_tpu.obs.alerts as JA
import dmclock_tpu.obs.registry as JR
import dmclock_tpu.obs.slo as JSLO
import dmclock_tpu.utils.profile as JP
import dmclock_tpu_torch.obs.alerts as TA
import dmclock_tpu_torch.obs.registry as TR
import dmclock_tpu_torch.obs.slo as TSLO
import dmclock_tpu_torch.utils.profile as TP

JAX = types.SimpleNamespace(R=JR, P=JP, A=JA, SLO=JSLO)
PORT = types.SimpleNamespace(R=TR, P=TP, A=TA, SLO=TSLO)


def fill_registry(b):
    """Every metric type, labels, label variants of one family
    registered apart, callback gauges and timers with fixed samples."""
    reg = b.R.MetricsRegistry()
    c = reg.counter("dmclock_ops_total", "operations served")
    c.inc()
    c.inc(41)
    reg.counter("dmclock_ops_total", labels={"server": "1"}).inc(3)
    g = reg.gauge("dmclock_depth", "queue depth", labels={"q": "a"})
    g.set(2.5)
    g.inc(1)
    reg.gauge("dmclock_ratio", "a ratio").set(0.125)
    reg.gauge("dmclock_lazy", "callback gauge").set_function(lambda: 7.0)
    reg.counter("dmclock_other_total").inc(2)
    reg.gauge("dmclock_depth", "queue depth", labels={"q": "b"}).set(-3)
    h = reg.histogram("dmclock_lat_ns", "latency",
                      buckets=(10, 100, 1e3))
    for v in (5, 50, 500, 5000, 100):
        h.observe(v)
    reg.histogram("dmclock_dev_ns", "device histogram",
                  buckets=(1, 2, 4)).set_counts([1, 0, 3, 2], 17.5)
    t1, t2 = b.P.ProfileCombiner(), b.P.ProfileCombiner()
    for d in (100, 250, 175):
        t1._accumulate(d)
    t2._accumulate(1000)
    reg.timer("dmclock_step_ns", "step time", source=t1)
    reg.timer("dmclock_step_ns", source=t2)
    reg.timer("dmclock_idle_ns", "never timed", source=b.P.ProfileTimer())
    return reg


def test_exposition_is_byte_equal_to_jax():
    got, want = fill_registry(PORT), fill_registry(JAX)
    assert got.prometheus() == want.prometheus()
    assert got.snapshot() == want.snapshot()
    assert got.snapshot_json(sort_keys=True) == \
        want.snapshot_json(sort_keys=True)


def test_get_or_create_and_kind_clash_like_jax():
    for b in (JAX, PORT):
        reg = b.R.MetricsRegistry()
        a = reg.counter("x_total", labels={"s": "0"})
        assert reg.counter("x_total", labels={"s": "0"}) is a
        assert reg.counter("x_total", labels={"s": "1"}) is not a
        with pytest.raises(AssertionError, match="already registered"):
            reg.gauge("x_total", labels={"s": "0"})
        with pytest.raises(AssertionError, match="only go up"):
            a.inc(-1)


def test_profile_timers_equal_jax():
    out = []
    for b in (JAX, PORT):
        comb = b.P.ProfileCombiner()
        for ds in ((3, 9, 4), (), (100,)):
            t = b.P.ProfileCombiner()
            for d in ds:
                t._accumulate(d)
            comb.combine(t)
        tm = b.P.ProfileTimer()
        tm.start()
        tm.start()                      # a reentry, counted
        tm.stop()
        out.append((comb.count, comb.sum_ns, comb.sum_sq_ns, comb.low_ns,
                    comb.high_ns, comb.mean_ns(), comb.std_dev_ns(),
                    tm.count, tm.reentries))
    assert out[0] == out[1]


@pytest.mark.parametrize("summary", [
    {"dispatch_ms_per_launch": 0.25, "device_ms_per_launch": 1.5,
     "host_overhead_frac": 0.75},
    {"device_ms_per_launch": 2, "unrelated": 9},
], ids=["full", "partial"])
def test_publish_span_gauges_equals_jax(summary):
    texts = []
    for b in (JAX, PORT):
        reg = b.R.MetricsRegistry()
        b.R.publish_span_gauges(reg, summary, labels={"run": "r"})
        texts.append(reg.prometheus())
    assert texts[0] == texts[1]
    assert "dmclock_device_ms_per_launch" in texts[1]


def test_default_registry_is_process_wide():
    assert TR.default_registry() is TR.default_registry()
    assert isinstance(TR.default_registry(), TR.MetricsRegistry)


# ----------------------------------------------------------------------
# the HTTP endpoint, over real sockets
# ----------------------------------------------------------------------

def _request(url, method="GET", body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def _echo(method, path, body):
    if path.endswith("/boom"):
        raise KeyError("boom")
    return 200, "application/json", json.dumps(
        {"method": method, "path": path, "body": body.decode()}).encode()


def serve_requests(b):
    reg = fill_registry(b)
    with b.R.MetricsHTTPServer(reg, port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        srv.mount("/api", _echo)
        with pytest.raises(ValueError):
            srv.mount("/api", _echo)
        for bad in ("api", "/api/"):
            with pytest.raises(ValueError):
                srv.mount(bad, _echo)
        base = f"http://{srv.host}:{srv.port}"
        out = [_request(srv.url), _request(base + "/"),
               _request(base + "/metrics.json"),
               _request(srv.healthz_url), _request(base + "/nope"),
               _request(base + "/api"), _request(base + "/api/x?q=1"),
               _request(base + "/api/x", "POST", b'{"a": 1}'),
               _request(base + "/api/y", "PUT", b"up"),
               _request(base + "/api/z", "DELETE"),
               _request(base + "/api/boom"),
               _request(base + "/apiary"),
               _request(base + "/metrics", "POST", b"")]
    return out


def test_http_endpoint_answers_like_jax():
    got, want = serve_requests(PORT), serve_requests(JAX)
    assert got == want
    assert got[0][0] == 200 and got[0][2].startswith(b"# HELP")
    assert got[3][2] == b'{"status": "ok"}'
    assert got[4][0] == 404 and got[10][0] == 500


def test_start_http_server_fails_soft():
    assert TR.start_http_server(port=-1) is None
    with pytest.raises(OverflowError):
        TR.start_http_server(port=-1, fail_soft=False)
    srv = TR.start_http_server(TR.MetricsRegistry(), port=0)
    try:
        assert _request(srv.healthz_url)[0] == 200
    finally:
        srv.close()


# ----------------------------------------------------------------------
# the burn-rate evaluator
# ----------------------------------------------------------------------

def _roll(b, plane, seq, e0, rows):
    """Synthetic closed windows (cid, ops, cost, resv, tardy, backlog)
    appended to the plane's ring, as one roll."""
    out = []
    for cid, ops, cost, resv, tardy, backlog in rows:
        w = b.SLO.ClosedWindow(seq=seq, cid=cid,
                               cepoch=plane.cepoch.get(cid, 1), e0=e0,
                               e1=e0 + 2, ops=ops, cost=cost,
                               resv_ops=resv, tardy_ops=tardy,
                               tard_sum_ns=tardy * 10 ** 6, lb_ops=ops // 4,
                               backlog=backlog)
        out.append(w)
        plane.rings.setdefault(cid, deque(maxlen=plane.ring_depth)) \
            .append(w)
    plane.window_seq = seq + 1
    plane.windows_closed += len(out)
    return out


def evaluate(b, seed: int, slow_windows: int):
    """Seeded random rolls over four clients, an eviction and a
    re-registration (a new contract epoch) halfway; returns what the
    evaluator reports."""
    rng = np.random.default_rng(seed)
    plane = b.SLO.SloPlane(4, dt_epoch_ns=10 ** 9, ring_depth=8)
    plane.register(0, 50.0, 1.0, 0.0)
    plane.register(1, 0.0, 1.0, 10.0)
    plane.register(2, 5.0, 3.0, 0.0)
    plane.register(3, 0.0, 2.0, 0.0)
    reg = b.R.MetricsRegistry()
    logged = []
    ev = b.A.SloEvaluator(plane, slow_windows=slow_windows,
                          registry=reg, log=logged.append)
    verdicts = []
    for r in range(10):
        if r == 5:
            plane.evict(0)
            plane.register(0, 20.0, 2.0, 0.0)
        rows = [(c, int(rng.integers(0, 60)), int(rng.integers(0, 90)),
                 int(rng.integers(0, 30)), int(rng.integers(0, 5)),
                 int(rng.integers(0, 3)))
                for c in range(4) if rng.random() < 0.9]
        verdicts.append(ev.observe_roll(_roll(b, plane, r, 2 * r, rows)))
    enc = {k: np.asarray(v).tolist() for k, v in ev.encode().items()}
    return dict(verdicts=verdicts, logged=logged, summary=ev.summary(),
                encode=enc, fired=ev.fired, text=reg.prometheus(),
                p99=ev.window_tardiness_p99_ns())


@pytest.mark.parametrize("seed, slow", [(0, 1), (1, 2), (2, 4), (3, 2)])
def test_evaluator_equals_jax(seed, slow):
    got, want = evaluate(PORT, seed, slow), evaluate(JAX, seed, slow)
    assert got == want
    assert TA.RULES == JA.RULES


def test_evaluator_encode_load_across_packages():
    """A JAX evaluator's encoding loads into the port's (and back) and
    carries on mid-episode identically."""
    plane_j = JSLO.SloPlane(2, dt_epoch_ns=10 ** 9)
    plane_j.register(0, 50.0, 1.0, 0.0)
    plane_j.register(1, 0.0, 1.0, 0.0)
    ev_j = JA.SloEvaluator(plane_j, slow_windows=2, log=lambda _l: None)
    for i in range(3):
        ev_j.observe_roll(_roll(JAX, plane_j, i, 2 * i,
                                [(0, 0, 0, 0, 0, 9), (1, 30, 30, 0, 0, 0)]))
    enc = {**ev_j.encode(), **plane_j.encode()}
    plane_t = TSLO.SloPlane.load(enc, capacity=2, dt_epoch_ns=10 ** 9)
    ev_t = TA.SloEvaluator(plane_t, slow_windows=2, log=lambda _l: None)
    ev_t.load(enc)
    assert ev_t.summary() == ev_j.summary()
    more = [(0, 0, 0, 0, 0, 9), (1, 0, 0, 0, 0, 4)]
    assert ev_t.observe_roll(_roll(PORT, plane_t, 3, 6, more)) == \
        ev_j.observe_roll(_roll(JAX, plane_j, 3, 6, more))
    back = JA.SloEvaluator(plane_j, slow_windows=2, log=lambda _l: None)
    back.load(ev_t.encode())
    assert back.summary() == ev_t.summary()
    for k, v in TA.SloEvaluator.empty_leaves().items():
        assert np.asarray(v).shape == \
            np.asarray(JA.SloEvaluator.empty_leaves()[k]).shape


def test_slo_api_mounted_over_http():
    bodies = []
    for b in (JAX, PORT):
        plane = b.SLO.SloPlane(2, dt_epoch_ns=10 ** 9)
        plane.register(0, 50.0, 1.0, 0.0)
        ev = b.A.SloEvaluator(plane, slow_windows=1, log=lambda _l: None)
        ev.observe_roll(_roll(b, plane, 0, 0, [(0, 0, 0, 0, 0, 9)]))
        assert b.A.mount_slo_api(None, ev) is None
        with b.R.MetricsHTTPServer(b.R.MetricsRegistry()) as srv:
            b.A.mount_slo_api(srv, ev)
            base = f"http://{srv.host}:{srv.port}"
            bodies.append((_request(base + "/slo"),
                           _request(base + "/slo", "POST", b"{}"),
                           _request(srv.url)))
    assert bodies[0] == bodies[1]
    assert json.loads(bodies[1][0][2])["resv_miss_episodes"] == 1
