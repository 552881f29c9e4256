"""The port's ctypes binding of the native C++ runtime
(``dmclock_tpu_torch.native``) against the JAX package's binding of the
same library, and against the port's oracle.

The same seeded operation sequences (``tests/test_native_parity.py``'s
differential runs, GC with an injected clock, the prop heap) go through
both bindings; every ``PullReq`` row, add return code and counter must
be equal.  The port's ``dmc_sim --model dmclock-native`` trace must equal
the JAX package's and the port's ``dmclock-delayed`` op for op
(``tests/test_sim_native_parity.py``), with and without
``--use-prop-heap``.  Skips only when the library cannot be had
(``load_library()`` is None), as ``tests/test_native_parity.py`` does."""

import os
import random
import time

import pytest

import dmclock_tpu.core as jcore
import dmclock_tpu_torch.core as tcore
from dmclock_tpu import native as jnative
from dmclock_tpu_torch import models as tmodels
from dmclock_tpu_torch import native as tnative
from dmclock_tpu_torch.sim import dmc_sim as tdmc
from dmclock_tpu_torch.sim.config import parse_config_file as tparse

def _libraries_loaded() -> bool:
    """Both bindings' libraries.  The port's loader builds under a lock
    and renames the library into place; the JAX binding's unlocked build
    may have failed in this process, or its load have met a library
    another process's build was still writing in place, so once the
    port's library is in place the JAX binding looks for it again (its
    kept failure cleared), up to three times two seconds apart."""
    if tnative.load_library() is None:
        return False
    for attempt in range(3):
        try:
            if jnative.load_library() is not None:
                return True
        except OSError:
            pass
        jnative._lib_err = None
        time.sleep(2)
    return False


if not _libraries_loaded():
    pytest.skip("native dmclock library unavailable (no toolchain)",
                allow_module_level=True)

S = 1_000_000_000
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def pr_row(pr):
    return (pr.type.value, pr.client, pr.request,
            None if pr.phase is None else int(pr.phase), pr.cost,
            pr.when_ready)


def drive(core, make, seed, at_limit, delayed, anticipation_ns):
    """A seeded add / pull / update / remove sequence on the queue
    ``make(info_f, **kw)`` builds; its observations."""
    rng = random.Random(seed)
    infos = {}
    for c in range(rng.randint(3, 8)):
        kind = rng.randrange(4)
        if kind == 0:
            infos[c] = core.ClientInfo(rng.uniform(0.5, 4), 0, 0)
        elif kind == 1:
            infos[c] = core.ClientInfo(0, rng.uniform(0.5, 4), 0)
        elif kind == 2:
            infos[c] = core.ClientInfo(rng.uniform(0.5, 2),
                                       rng.uniform(0.5, 4),
                                       rng.uniform(3, 8))
        else:
            infos[c] = core.ClientInfo(rng.uniform(0.5, 2),
                                       rng.uniform(0.5, 4), 0)
    q = make(lambda c: infos[c], delayed_tag_calc=delayed,
             at_limit=getattr(core.AtLimit, at_limit),
             anticipation_timeout_ns=anticipation_ns)
    out = []
    now = S
    for step in range(200):
        now += rng.randint(0, S // 2)
        op = rng.random()
        c = rng.randrange(len(infos))
        if op < 0.55:
            delta = rng.randint(1, 5)
            out.append(q.add_request(("req", c, step), c,
                                     core.ReqParams(delta,
                                                    rng.randint(1, delta)),
                                     time_ns=now, cost=rng.randint(1, 3)))
        elif op < 0.93:
            out.append(pr_row(q.pull_request(now)))
        elif op < 0.97:
            infos[c] = core.ClientInfo(rng.uniform(0.5, 2),
                                       rng.uniform(0.5, 4), 0)
            q.update_client_info(c)
        else:
            acc = []
            q.remove_by_client(c, reverse=bool(step % 2),
                               accum=acc.append)
            out.append(acc)
    for _ in range(600):
        now += 4 * S
        out.append(pr_row(q.pull_request(now)))
        if q.request_count() == 0:
            break
    out.append((q.reserv_sched_count, q.prop_sched_count,
                q.limit_break_sched_count, q.request_count(),
                q.client_count(), q.empty()))
    return out


CASES = [(seed, at, delayed, ant)
         for seed, (at, ant) in enumerate([("WAIT", 0), ("ALLOW", 0),
                                           ("WAIT", S // 10),
                                           ("ALLOW", S // 20)], start=31)
         for delayed in (True, False)] + \
    [(41, "REJECT", False, 0), (42, "REJECT", False, S // 10)]


@pytest.mark.parametrize("seed,at_limit,delayed,anticipation_ns", CASES)
def test_native_rows_equal_jax_binding(seed, at_limit, delayed,
                                       anticipation_ns):
    got = drive(tcore, tnative.NativePullPriorityQueue, seed, at_limit,
                delayed, anticipation_ns)
    want = drive(jcore, jnative.NativePullPriorityQueue, seed, at_limit,
                 delayed, anticipation_ns)
    assert got == want
    oracle = drive(tcore, lambda f, **kw: tcore.PullPriorityQueue(
        f, run_gc_thread=False, **kw), seed, at_limit, delayed,
        anticipation_ns)
    assert got == oracle


@pytest.mark.parametrize("borrowing", [False, True])
def test_native_tracker_equals_jax_binding(borrowing):
    rng = random.Random(7 + borrowing)
    t = tnative.NativeServiceTracker(borrowing=borrowing)
    j = jnative.NativeServiceTracker(borrowing=borrowing)
    outstanding = []
    for _ in range(300):
        if rng.random() < 0.5 or not outstanding:
            srv = rng.choice(["s0", "s1", "s2"])
            a, b = t.get_req_params(srv), j.get_req_params(srv)
            assert (a.delta, a.rho) == (b.delta, b.rho)
            outstanding.append(srv)
        else:
            srv = outstanding.pop(rng.randrange(len(outstanding)))
            phase = rng.choice([0, 1])
            cost = rng.randint(1, 3)
            t.track_resp(srv, tcore.Phase(phase), cost)
            j.track_resp(srv, jcore.Phase(phase), cost)
    t.shutdown()
    j.shutdown()


def test_native_gc_and_prop_heap_equal_jax_binding():
    """Idle churn under an injected GC clock, with the prop heap on:
    both bindings serve the same stream and keep the same clients."""
    def run(core, native):
        rng = random.Random(81)
        infos = {c: core.ClientInfo(rng.choice([0, 1.0]), 1.0 + c % 3,
                                    rng.choice([0, 4.0])) for c in range(8)}
        q = native.NativePullPriorityQueue(
            lambda c: infos[c], delayed_tag_calc=True, use_prop_heap=True,
            idle_age_s=10.0, erase_age_s=30.0, check_time_s=1.0)
        out = [q.heap_branching()]
        now, fake = S, 0.0
        for burst in range(6):
            for step in range(40):
                now += rng.randint(0, S // 4)
                c = rng.randrange(8)
                if rng.random() < 0.6:
                    out.append(q.add_request((burst, step), c,
                                             core.ReqParams(1, 1),
                                             time_ns=now))
                else:
                    out.append(pr_row(q.pull_request(now)))
            fake += 15.0
            q.set_fake_clock(fake)
            q.do_clean()
            out.append(q.client_count())
        return out

    assert run(tcore, tnative) == run(jcore, jnative)


def _cut_conf(tmp_path, total_ops):
    src = os.path.join(CONFIGS, "dmc_sim_example.conf")
    lines = [f"client_total_ops = {total_ops}"
             if ln.split("=")[0].strip() == "client_total_ops" else ln
             for ln in open(src).read().splitlines()]
    path = tmp_path / "cut.conf"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("prop_heap", [False, True])
def test_dmc_sim_native_trace_equals_jax_and_oracle(tmp_path, prop_heap):
    from dmclock_tpu.sim import dmc_sim as jdmc

    conf = _cut_conf(tmp_path, 100)
    flag = ["--use-prop-heap"] if prop_heap else []
    traces = {}
    for name, main, extra in (
            ("port", tdmc.main, ["--device", "cpu"]),
            ("jax", jdmc.main, [])):
        path = tmp_path / f"{name}.jsonl"
        assert main(["-c", conf, "--model", "dmclock-native", "--trace",
                     str(path)] + extra + flag) == 0
        traces[name] = path.read_bytes()
    assert tmodels.USE_PROP_HEAP is prop_heap
    path = tmp_path / "oracle.jsonl"
    assert tdmc.main(["-c", conf, "--model", "dmclock-delayed", "--trace",
                      str(path), "--device", "cpu"]) == 0
    assert traces["port"] == traces["jax"]
    assert traces["port"].count(b"\n") == 400
    # the oracle's rows carry its tags; the native ones none
    import json
    strip = [{k: v for k, v in json.loads(ln).items() if k != "tag"}
             for ln in path.read_text().splitlines()]
    assert strip == [{k: v for k, v in json.loads(ln).items() if k != "tag"}
                     for ln in traces["port"].decode().splitlines()]
    sim = tdmc.run_sim(tparse(conf), model="dmclock-native", seed=7,
                       record_trace=True, device="cpu")
    ref = tdmc.run_sim(tparse(conf), model="dmclock-delayed", seed=7,
                       record_trace=True, device="cpu")
    assert sim.trace == ref.trace
