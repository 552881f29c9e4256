"""The port's registry publishers against the JAX package's, byte for
byte: the same seeded histogram, ledger, provenance and metrics blocks
(numpy, then a JAX array and a torch tensor) go into each package's
registry, and the Prometheus exposition and JSON snapshot must be equal
(``tests/test_obs.py``'s and ``tests/test_provenance.py``'s publish
checks).  Then the host monitors' routing: ``StarvationMonitor`` with a
registry and a watchdog (``tests/test_provenance.py:272``), and
``SloEvaluator(watchdog=)`` routing every fired rule through
``external_warning``, each against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.obs import device as jdev
from dmclock_tpu.obs import histograms as jhist
from dmclock_tpu.obs import provenance as jprov
from dmclock_tpu.obs import slo as jslo
from dmclock_tpu.obs import spans as jspans
from dmclock_tpu.obs.alerts import SloEvaluator as JEval
from dmclock_tpu.obs.registry import MetricsRegistry as JRegistry
from dmclock_tpu.obs.watchdog import Watchdog as JWatchdog
from dmclock_tpu_torch.obs import device as tdev
from dmclock_tpu_torch.obs import histograms as thist
from dmclock_tpu_torch.obs import provenance as tprov
from dmclock_tpu_torch.obs import slo as tslo
from dmclock_tpu_torch.obs import spans as tspans
from dmclock_tpu_torch.obs.alerts import SloEvaluator as TEval
from dmclock_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from dmclock_tpu_torch.obs.watchdog import Watchdog as TWatchdog

N = 64


def _blocks(seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1000, (jhist.NUM_HISTS, jhist.NUM_BUCKETS + 1),
                     dtype=np.int64)
    led = rng.integers(0, 10_000, (N, jhist.LED_COLS), dtype=np.int64)
    prov = (rng.integers(0, 500, jhist.NUM_BUCKETS + 1, dtype=np.int64),
            rng.integers(1, 10_000, jprov.PS_FIELDS, dtype=np.int64),
            rng.integers(0, 10 ** 9, N, dtype=np.int64))
    met = rng.integers(0, 10 ** 6, jdev.NUM_METRICS, dtype=np.int64)
    return h, led, prov, met


def _expose(reg):
    return reg.prometheus(), reg.snapshot_json(sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("labels", [None, {"workload": "cfg4"}])
def test_publishers_expose_the_same_bytes(seed, labels):
    h, led, prov, met = _blocks(seed)
    jr, tr = JRegistry(), TRegistry()
    jhist.publish_hists(jr, jnp.asarray(h), labels=labels)
    thist.publish_hists(tr, torch.from_numpy(h), labels=labels)
    jhist.publish_ledger(jr, jnp.asarray(led), labels=labels)
    thist.publish_ledger(tr, torch.from_numpy(led), labels=labels)
    jprov.publish_provenance(jr, jprov.ProvBlock(*map(jnp.asarray, prov)),
                             labels=labels)
    tprov.publish_provenance(tr, tprov.ProvBlock(*map(torch.from_numpy,
                                                      prov)),
                             labels=labels)
    jdev.publish(jr, jnp.asarray(met), labels=labels)
    tdev.publish(tr, torch.from_numpy(met), labels=labels)
    jdev.publish(jr, jnp.asarray(met), prefix="eng")
    tdev.publish(tr, torch.from_numpy(met), prefix="eng")
    assert _expose(tr) == _expose(jr)
    text = tr.prometheus()
    assert "dmclock_resv_tardiness_ns_bucket" in text
    assert "dmclock_ledger_ops" in text
    assert "dmclock_provenance_margin_p99_ns" in text
    assert "eng_decisions_total" in text
    # a publish is a drain (set, not add): publishing again changes nothing
    thist.publish_hists(tr, torch.from_numpy(h), labels=labels)
    thist.publish_ledger(tr, torch.from_numpy(led), labels=labels)
    assert tr.prometheus() == text


def _wd_pair():
    logs = ([], [])
    regs = (JRegistry(), TRegistry())
    wds = (JWatchdog(jspans.SpanTracer(), registry=regs[0],
                     log=logs[0].append),
           TWatchdog(tspans.SpanTracer(), registry=regs[1],
                     log=logs[1].append))
    return wds, regs, logs


@pytest.mark.parametrize("via", ["registry", "attach"])
def test_starvation_monitor_routes_like_jax(via):
    wds, regs, logs = _wd_pair()
    mons = []
    for prov, wd, reg in zip((jprov, tprov), wds, regs):
        kw = {"registry": reg} if via == "registry" else {}
        mon = prov.StarvationMonitor(100, watchdog=wd, **kw)
        if via == "attach":
            mon.attach_registry(reg)
        mons.append(mon)
    backlog = np.asarray([1, 1, 0, 1])
    steps = [(np.asarray([0, 0, 0, 0]), 500), (np.asarray([0, 0, 0, 0]), 600),
             (np.asarray([590, 0, 0, 0]), 600),
             (np.asarray([590, 0, 0, 700]), 800),
             (np.asarray([900, 900, 900, 900]), 950)]
    for last, now in steps:
        jp = jprov.prov_init(4)._replace(last_served=jnp.asarray(last))
        tp = tprov.prov_init(4, device="cpu")._replace(
            last_served=torch.from_numpy(last))
        a = mons[0].observe(jp, now, backlog=backlog)
        b = mons[1].observe(tp, now, backlog=torch.from_numpy(backlog))
        assert a == b
    assert mons[0].fired == mons[1].fired
    assert mons[1].episodes_total == 4
    assert wds[0].warnings == wds[1].warnings
    assert [w["kind"] for w in wds[1].warnings] == ["client_starved"] * 4
    assert logs[0] == logs[1]
    assert _expose(regs[1]) == _expose(regs[0])
    assert regs[1].counter(
        "dmclock_watchdog_warnings_total").value == 4


def test_starvation_monitor_without_watchdog_logs():
    logs = ([], [])
    for prov, log, p in ((jprov, logs[0], jprov.prov_init(2)),
                         (tprov, logs[1], tprov.prov_init(2, device="cpu"))):
        prov.StarvationMonitor(10, log=log.append).observe(
            p, 100, backlog=np.asarray([1, 0]))
    assert logs[0] == logs[1] and logs[1][0].startswith("# starvation:")


def _slo_run(slo, Eval, wd, log, reg):
    """Two clients, client 0 with a reservation it never gets: rolls of
    windows until the burn fires (the same blocks on both sides)."""
    plane = slo.SloPlane(2, dt_epoch_ns=100_000_000, ring_depth=8)
    plane.register(0, 100.0, 1.0, 0.0)
    plane.register(1, 0.0, 1.0, 0.0)
    ev = Eval(plane, slow_windows=2, watchdog=wd, log=log, registry=reg)
    out = []
    for e in range(5):
        blk = np.zeros((2, slo.W_FIELDS), dtype=np.int64)
        blk[:, slo.W_CEPOCH] = [plane.cepoch[0], plane.cepoch[1]]
        blk[1, slo.W_OPS] = 50
        blk[0, slo.W_OPS] = 1
        blk[0, slo.W_RESV_OPS] = 1
        block = blk if slo is jslo else torch.from_numpy(blk)
        _, closed = plane.roll(block, e, e + 1,
                               depth=np.asarray([5, 0]))
        out.append(ev.observe_roll(closed))
    return out, ev.summary()


def test_slo_evaluator_routes_through_watchdog_like_jax():
    wds, regs, logs = _wd_pair()
    slo_logs = ([], [])
    got = [_slo_run(slo, Eval, wd, sl.append, reg)
           for slo, Eval, wd, sl, reg in zip((jslo, tslo), (JEval, TEval),
                                              wds, slo_logs, regs)]
    assert got[0] == got[1]
    assert wds[0].warnings == wds[1].warnings
    assert wds[1].warnings and all(w["kind"].startswith("slo_")
                                   for w in wds[1].warnings)
    # routed through the watchdog: no "# slo:" line of its own
    assert slo_logs == ([], [])
    assert logs[0] == logs[1]
    assert _expose(regs[1]) == _expose(regs[0])
