"""The port's capacity plane (``obs/capacity.py``) against the JAX
package's: the per-subsystem ledger key by key at n = 256, 512 and 1000
for the prefix, chain, calendar-minstop and calendar-wheel engines with
the telemetry accumulators, the SLO block, a flight ring and the
lifecycle slot map; the fitted model, ``projected_hbm``, the
``plan_capacity`` / ``fits`` round trip, ``classify``, the budget
override, the planner outputs that differ from bench's and by how much,
the published gauges, and the capacity record of bench's churn row (the
mesh row's is held in ``tests/test_torch_mesh.py``).

One difference is deliberate.  The JAX ledger takes the epoch output
blocks from ``jax.eval_shape`` of the epoch scan; with an accumulator
passed, that trace fails (the accumulators ride in as abstract values)
and the JAX ledger falls back to the closed form ``m * max(k, 1) * 16``.
The port measures the real blocks of one CPU epoch, so its
``epoch_outputs`` equals the JAX ledger's traced value, the one it gives
with the accumulators off."""

import pytest

import bench
from dmclock_tpu.obs import capacity as J
from dmclock_tpu.obs import registry as jreg
from dmclock_tpu_torch import serve as tserve
from dmclock_tpu_torch.obs import capacity as T
from dmclock_tpu_torch.obs import registry as treg

ENGINES = {
    "prefix": dict(engine="prefix", m=4, k=256),
    "chain": dict(engine="chain", m=2, k=8, chain_depth=3),
    "minstop": dict(engine="calendar", m=3, k=4, calendar_impl="minstop"),
    "wheel": dict(engine="calendar", m=3, k=4, calendar_impl="wheel",
                  ladder_levels=2),
}
PLANES = dict(telemetry=True, slo=True, flight_records=64, lifecycle=True)


@pytest.mark.parametrize("n", [256, 512, 1000])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_hbm_ledger_equals_jax(engine, n):
    cfg = dict(ring=16, stream_chunk=8, **ENGINES[engine])
    got = T.hbm_ledger(n, **cfg, **PLANES)
    want = J.hbm_ledger(n, **cfg, **PLANES)
    assert got.keys() == want.keys()
    for key in want:
        if key != "epoch_outputs":
            assert got[key] == want[key], key
    # the JAX ledger's closed-form fallback with accumulators on ...
    m, k = cfg["m"], cfg["k"]
    assert want["epoch_outputs"] == m * max(k, 1) * 16 * 8
    # ... and its traced value, which the port's real blocks equal
    traced = J.hbm_ledger(n, **cfg)
    assert got["epoch_outputs"] == traced["epoch_outputs"]
    assert T.hbm_ledger(n, **cfg) == traced
    assert T.projected_total(got) == sum(got.values())


def test_model_plan_and_fits_round_trip():
    cfg = dict(ring=16, engine="prefix", m=4, k=256, telemetry=True,
               slo=True, stream_chunk=8)
    model = T.capacity_model(**cfg)
    for n in (256, 700, 12_500):
        assert model.total(n) == T.projected_total(T.hbm_ledger(n, **cfg))
        assert T.projected_hbm(n, **cfg) == model.total(n)
    budget = 8 << 30
    plan = T.plan_capacity(budget, **cfg)
    n = plan["max_clients"]
    assert n > 100_000
    assert T.fits(n, budget, **cfg) and not T.fits(n + 1, budget, **cfg)
    assert plan["projected_bytes"] == model.total(n)
    assert plan["ledger"] == model.ledger(n)
    # with the accumulators off the JAX ledger traces, and the two
    # planners agree on every key
    off = dict(ring=16, engine="chain", m=2, k=8)
    tp, jp = T.plan_capacity(budget, **off), J.plan_capacity(budget, **off)
    assert tp == jp
    assert T.fits(tp["max_clients"], budget, **off) == \
        J.fits(jp["max_clients"], budget, **off)
    with pytest.raises(ValueError):
        T.plan_capacity(None, device="cpu", **off)


# the mesh row's configuration (bench.plan_mesh_shards' defaults)
MESH_CAP = dict(ring=16, engine="prefix", m=4, k=256, telemetry=True,
                slo=True, stream_chunk=8)


def test_planner_outputs_that_differ_from_bench(monkeypatch):
    """Where the deliberate ``epoch_outputs`` difference reaches the
    planner, and by how much, at the mesh row's configuration: one
    chunk's output blocks are 83,360 bytes in the port against the JAX
    closed form's 131,072, so a shard's projection is 47,712 bytes
    lower (6,322,428 against 6,370,140 at 12,500 clients), and a budget
    fits 95 or 96 more clients a shard (499 bytes a client).  The
    mesh row's shard count is the same at 100,000 clients on 80 GiB; at
    a budget's edge it can differ by one."""
    got, want = T.hbm_ledger(12_500, **MESH_CAP), \
        J.hbm_ledger(12_500, **MESH_CAP)
    assert {k for k in want if got[k] != want[k]} == {"epoch_outputs"}
    assert (got["epoch_outputs"], want["epoch_outputs"]) == \
        (83_360, 131_072)
    assert (T.projected_hbm(12_500, **MESH_CAP),
            J.projected_hbm(12_500, **MESH_CAP)) == (6_322_428, 6_370_140)
    assert T.capacity_model(**MESH_CAP).bytes_per_client == \
        J.capacity_model(**MESH_CAP).bytes_per_client == 499
    for budget, more in ((80 << 30, 95), (16 << 20, 96)):
        assert T.plan_capacity(budget, **MESH_CAP)["max_clients"] - \
            J.plan_capacity(budget, **MESH_CAP)["max_clients"] == more
    monkeypatch.setenv("DMCLOCK_HBM_BUDGET_BYTES", str(80 << 30))
    tp = tserve.plan_mesh_shards(100_000, device="cpu")
    jp = bench.plan_mesh_shards(100_000)
    assert tp["shards_planned"] == jp["shards_planned"] == 1
    assert jp["projected_hbm_bytes_per_shard"] - \
        tp["projected_hbm_bytes_per_shard"] == 131_072 - 83_360
    # 16 MiB a shard: 60,000 clients are 2 shards in the port, 3 in bench
    monkeypatch.setenv("DMCLOCK_HBM_BUDGET_BYTES", str(16 << 20))
    assert tserve.plan_mesh_shards(60_000, device="cpu")[
        "shards_planned"] == 2
    assert bench.plan_mesh_shards(60_000)["shards_planned"] == 3


def test_budget_override_and_peaks(monkeypatch):
    monkeypatch.delenv("DMCLOCK_HBM_BUDGET_BYTES", raising=False)
    assert T.device_hbm_budget("cpu") is None
    monkeypatch.setenv("DMCLOCK_HBM_BUDGET_BYTES", "123456789")
    assert T.device_hbm_budget() == J.device_hbm_budget() == 123456789
    monkeypatch.setenv("DMCLOCK_HBM_BUDGET_BYTES", "0")
    assert T.device_hbm_budget() is None and J.device_hbm_budget() is None
    monkeypatch.setenv("DMCLOCK_HBM_BUDGET_BYTES", str(16 << 20))
    plan = tserve.plan_mesh_shards(100_000, device="cpu")
    per = T.plan_capacity(16 << 20, ring=16, engine="prefix", m=4,
                          k=256, telemetry=True, slo=True,
                          stream_chunk=8)["max_clients"]
    assert plan["max_clients_per_shard"] == per
    assert plan["shards_planned"] == -(-100_000 // per) > 1
    assert plan["n_shards"] == plan["shards_planned"]
    over = tserve.plan_mesh_shards(100_000, 2, device="cpu")
    assert over["over_budget"] is True and over["n_shards"] == 2
    assert T.device_peaks("cpu")["label"] == "unknown"


@pytest.mark.parametrize("kw", [
    dict(flops=1e9, bytes_accessed=1e9),
    dict(flops=1e12, bytes_accessed=1e6),
    dict(flops=0.0, bytes_accessed=0.0),
    dict(flops=1e9, bytes_accessed=1e9, device_time_s=1e-3,
         dispatch_time_s=4e-3),
    dict(flops=1e9, bytes_accessed=1e9, device_time_s=4e-3,
         dispatch_time_s=1e-3),
])
def test_classify_equals_jax(kw):
    peaks = dict(peak_flops=67e12, peak_bytes_per_s=3.35e12)
    assert T.classify(**kw, **peaks) == J.classify(**kw, **peaks)
    row = {"cost_analysis": {"flops": kw["flops"],
                             "bytes_accessed": kw["bytes_accessed"]}}
    if "device_time_s" in kw:
        row["spans"] = {"device_ms_per_launch": kw["device_time_s"] * 1e3,
                        "dispatch_ms_per_launch":
                            kw["dispatch_time_s"] * 1e3}
    assert T.classify_bench_row(row, peaks=peaks) == \
        J.classify_bench_row(row, peaks=peaks)


def test_publish_and_row_records():
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    for pkg, reg in ((J, jr), (T, tr)):
        pkg.publish_capacity_metrics(reg, projected_bytes=123,
                                     budget_bytes=456, max_clients=7,
                                     workload="mesh")
    text = tr.prometheus()
    assert 'dmclock_capacity_max_clients{workload="mesh"} 7' in text
    assert [ln for ln in text.splitlines() if not ln.startswith("#")] == \
        [ln for ln in jr.prometheus().splitlines()
         if not ln.startswith("#")]
    # bench's churn row carries the capacity record
    row = tserve.churn_row("flash_crowd", total_ids=32, epochs=8, k=16,
                           device="cpu")
    assert row["projected_hbm_bytes"] == T.projected_hbm(
        32, ring=32, engine="prefix", m=4, k=16, telemetry=True,
        slo=True, lifecycle=True)
    assert "roofline" not in row and "bound_class" not in row
