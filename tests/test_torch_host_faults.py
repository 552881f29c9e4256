"""The port's host fault plans (``robust/host_faults.py``) against the
JAX package's: sampled plans equal over seeds, the JSON round trip in
both directions, the exactly-once fired journal, scrape loss, and
``around_save`` giving torn saves and a rotted payload."""

import pytest

from dmclock_tpu.robust import host_faults as JH
from dmclock_tpu_torch.engine.state import init_state
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.utils import checkpoint as ckpt_mod

SAMPLE_KW = [
    dict(epochs=8, est_decisions=1000, kills=2, save_kills=1,
         corrupt_saves=1, scrape_drops=1),
    dict(epochs=6, est_decisions=300, kills=1, save_kills=3,
         corrupt_saves=2, scrape_drops=2, ckpt_every=3),
    dict(epochs=1, est_decisions=5, kills=3, save_kills=1,
         ckpt_every=2),
]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("kw", range(len(SAMPLE_KW)))
def test_sampled_plan_equals_jax(seed, kw):
    got = TH.sample_host_plan(seed, **SAMPLE_KW[kw])
    want = JH.sample_host_plan(seed, **SAMPLE_KW[kw])
    assert tuple(got) == tuple(want)
    assert TH.describe_host(got) == JH.describe_host(want)
    assert TH.host_plan_events(got) == JH.host_plan_events(want)


def test_events_and_describe_equal_jax():
    kw = dict(kill_at_decisions=(10, 20), kill_at_save=((1, "data_renamed"),),
              corrupt_save_at=(3,), drop_scrape_at=(0, 2),
              kill_at_controller=((2, "after_journal"),))
    got, want = TH.HostFaultPlan(**kw), JH.HostFaultPlan(**kw)
    assert TH.host_plan_events(got) == JH.host_plan_events(want)
    assert TH.describe_host(got) == JH.describe_host(want) == \
        "host:kill2+savekill1+corrupt1+scrape2+ctlkill1"
    assert TH.describe_host(None) == "none" == \
        TH.describe_host(TH.zero_host_plan())
    assert TH.CONTROLLER_STAGES == JH.CONTROLLER_STAGES


@pytest.mark.parametrize("seed", range(3))
def test_json_round_trip_crosses_packages(seed):
    plan = TH.sample_host_plan(seed, epochs=6, est_decisions=300, kills=2,
                               save_kills=1, corrupt_saves=1,
                               scrape_drops=1)
    obj = TH.plan_to_json(plan)
    assert TH.plan_from_json(obj) == plan
    assert tuple(JH.plan_from_json(obj)) == tuple(plan)
    jplan = JH.sample_host_plan(seed, epochs=6, est_decisions=300,
                                kills=2, save_kills=1, corrupt_saves=1,
                                scrape_drops=1)
    assert JH.plan_to_json(jplan) == obj
    assert TH.plan_from_json(TH.plan_to_json(None)) == TH.zero_host_plan()


def test_kill_fires_exactly_once_across_restarts(tmp_path):
    plan = TH.HostFaultPlan(kill_at_decisions=(100,))
    inj = TH.HostFaultInjector(plan, tmp_path)
    inj.after_decisions(50)
    with pytest.raises(TH.HostKill):
        inj.after_decisions(150)
    inj2 = TH.HostFaultInjector(plan, tmp_path)
    inj2.after_decisions(150)
    inj2.after_decisions(10 ** 9)
    assert "dec:0" in inj2.fired


def test_fired_journal_is_durable_before_the_kill(tmp_path):
    inj = TH.HostFaultInjector(TH.HostFaultPlan(kill_at_decisions=(1,)),
                               tmp_path)
    with pytest.raises(TH.HostKill):
        inj.after_decisions(5)
    fired = (tmp_path / TH.HostFaultInjector.FIRED_NAME).read_text()
    assert "dec:0" in fired
    assert TH.HostFaultInjector.FIRED_NAME == \
        JH.HostFaultInjector.FIRED_NAME


def test_drop_scrape_fires_once_per_point(tmp_path):
    inj = TH.HostFaultInjector(TH.HostFaultPlan(drop_scrape_at=(2, 2, 4)),
                               tmp_path)
    assert [inj.drop_scrape(e) for e in range(6)] == \
        [False, False, True, False, True, False]
    again = TH.HostFaultInjector(inj.plan, tmp_path)
    assert not any(again.drop_scrape(e) for e in range(6))
    assert again.fired == {"scrape:0", "scrape:1", "scrape:2"}


def test_controller_point_fires_once(tmp_path):
    plan = TH.HostFaultPlan(kill_at_controller=((2, "after_apply"),))
    inj = TH.HostFaultInjector(plan, tmp_path)
    inj.controller_point(2, "before_journal")
    with pytest.raises(TH.HostKill):
        inj.controller_point(2, "after_apply")
    inj.controller_point(2, "after_apply")


def test_save_stage_kill_uninstalls_the_hook(tmp_path):
    plan = TH.HostFaultPlan(kill_at_save=((0, "data_renamed"),))
    inj = TH.HostFaultInjector(plan, tmp_path)
    rot = tmp_path / "rot"
    st = init_state(8, 4, device="cpu")
    with pytest.raises(TH.HostKill):
        inj.around_save(0, lambda: ckpt_mod.save_pytree_rotating(rot, st))
    assert ckpt_mod._crash_hook is None
    assert ckpt_mod._post_commit_hook is None
    with pytest.raises(ckpt_mod.CheckpointCorruptError):
        ckpt_mod.restore_pytree(ckpt_mod.rotation_paths(rot)[-1],
                                init_state(8, 4, device="cpu"))
    # the point is spent: a retried save commits
    inj.around_save(0, lambda: ckpt_mod.save_pytree_rotating(rot, st))
    _, path = ckpt_mod.restore_pytree_rotating(
        rot, init_state(8, 4, device="cpu"))
    assert path == ckpt_mod.rotation_paths(rot)[-1]


@pytest.mark.parametrize("stage", [s for s in ckpt_mod.SAVE_STAGES
                                   if s != "done"])
def test_every_torn_stage_falls_back(tmp_path, stage):
    inj = TH.HostFaultInjector(TH.HostFaultPlan(kill_at_save=((0, stage),)),
                               tmp_path)
    rot = tmp_path / "rot"
    st = init_state(8, 4, device="cpu")
    first = ckpt_mod.save_pytree_rotating(rot, st)
    with pytest.raises(TH.HostKill):
        inj.around_save(0, lambda: ckpt_mod.save_pytree_rotating(rot, st))
    _, path = ckpt_mod.restore_pytree_rotating(
        rot, init_state(8, 4, device="cpu"))
    assert path == first


def test_corrupt_save_pair_fails_verification(tmp_path):
    inj = TH.HostFaultInjector(TH.HostFaultPlan(corrupt_save_at=(0,)),
                               tmp_path)
    rot = tmp_path / "rot"
    st = init_state(8, 4, device="cpu")
    ckpt_mod.save_pytree_rotating(rot, st)
    inj.around_save(0, lambda: ckpt_mod.save_pytree_rotating(rot, st))
    paths = ckpt_mod.rotation_paths(rot)
    assert len(paths) == 2
    with pytest.raises(ckpt_mod.CheckpointCorruptError):
        ckpt_mod.restore_pytree(paths[-1], init_state(8, 4, device="cpu"))
    _, path = ckpt_mod.restore_pytree_rotating(
        rot, init_state(8, 4, device="cpu"))
    assert path == paths[0]
    assert ckpt_mod._post_commit_hook is None
