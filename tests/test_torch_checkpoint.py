"""The port's checkpoints (``utils/checkpoint.py``): the JAX package's
checkpoint cases on the port (truncated file, flipped byte, missing
sidecar, shape mismatch, rotation past a corrupt newest entry, pruning,
an empty rotation, kills at every save stage, the in-place overwrite,
the double crash, supervised resumes after torn saves), the pull queue's
snapshot, and snapshots crossing packages both ways with equal leaves
and the same sidecar."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmclock_tpu.engine import init_state as jax_init_state
from dmclock_tpu.robust import supervisor as JS
from dmclock_tpu.utils import checkpoint as jckpt
from dmclock_tpu_torch.core.qos import ClientInfo
from dmclock_tpu_torch.core.recs import ReqParams
from dmclock_tpu_torch.engine.queue import TpuPullPriorityQueue
from dmclock_tpu_torch.engine.state import init_state
from dmclock_tpu_torch.lifecycle import make_spec
from dmclock_tpu_torch.robust import host_faults as TH
from dmclock_tpu_torch.robust import supervisor as TS
from dmclock_tpu_torch.utils import checkpoint as ckpt_mod
from dmclock_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                                queue_state_dict,
                                                restore_pytree,
                                                restore_pytree_rotating,
                                                restore_queue_state,
                                                rotation_paths, save_pytree,
                                                save_pytree_rotating)

from test_torch_support import assert_state_matches

S = 10 ** 9


def _state(mark: int):
    st = init_state(16, 8, device="cpu")
    head = st.head_resv.clone()
    head[3] = mark
    return st._replace(head_resv=head)


def _like():
    return init_state(16, 8, device="cpu")


def _sidecar(p) -> str:
    with open(str(p) + ".sha256") as fh:
        return fh.read().strip()


# ----------------------------------------------------------------------
# the pull queue
# ----------------------------------------------------------------------

def test_queue_checkpoint_resume(tmp_path):
    infos = {c: ClientInfo(10, 1.0 + c % 3, 0) for c in range(6)}

    def build():
        return TpuPullPriorityQueue(lambda c: infos[c], capacity=16,
                                    ring_capacity=16, device="cpu")

    q = build()
    for i in range(12):
        q.add_request(("r", i), i % 6, ReqParams(1, 1),
                      time_ns=(i + 1) * S // 4)
    pre = [q.pull_request(4 * S) for _ in range(5)]
    assert all(p.is_retn() for p in pre)
    host = queue_state_dict(q)          # flushes; must precede the save
    save_pytree(tmp_path / "engine", q.state)
    rest_orig = [q.pull_request(5 * S) for _ in range(7)]

    q2 = build()
    q2.state = restore_pytree(tmp_path / "engine", q2.state)
    restore_queue_state(q2, host)
    rest_resumed = [q2.pull_request(5 * S) for _ in range(7)]
    for a, b in zip(rest_orig, rest_resumed):
        assert (a.type, a.client, a.phase, a.cost) == \
            (b.type, b.client, b.phase, b.cost)


def test_queue_restore_rejects_a_mismatched_pair(tmp_path):
    q = TpuPullPriorityQueue(lambda c: ClientInfo(1, 1, 0), capacity=8,
                             ring_capacity=8, device="cpu")
    q.add_request("a", 0, ReqParams(1, 1), time_ns=S)
    host = queue_state_dict(q)
    host["payloads"] = {}
    with pytest.raises(ValueError, match="no host payload"):
        restore_queue_state(q, host)


# ----------------------------------------------------------------------
# corruption: a damaged snapshot never restores
# ----------------------------------------------------------------------

def test_restore_round_trips_dtypes(tmp_path):
    p = tmp_path / "snap"
    st = _state(111)
    save_pytree(p, st)
    got = restore_pytree(p, _like())
    for f, a, b in zip(st._fields, got, st):
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_restore_truncated_file(tmp_path):
    p = tmp_path / "snap"
    save_pytree(p, _state(111))
    raw = p.read_bytes()
    p.write_bytes(raw[:len(raw) // 2])
    with pytest.raises(CheckpointCorruptError):
        restore_pytree(p, _like())


def _flip_payload_byte(path, mark: int) -> None:
    """Flip one byte inside stored leaf data (found by the int64 mark's
    bytes)."""
    raw = bytearray(open(path, "rb").read())
    idx = bytes(raw).find(int(mark).to_bytes(8, "little"))
    assert idx > 0, "marker bytes not found in snapshot"
    raw[idx] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def test_restore_flipped_byte(tmp_path):
    p = tmp_path / "snap"
    mark = 0x0123456789AB
    save_pytree(p, _state(mark))
    _flip_payload_byte(p, mark)
    with pytest.raises(CheckpointCorruptError):
        restore_pytree(p, _like())


def test_restore_missing_sidecar(tmp_path):
    p = tmp_path / "snap"
    save_pytree(p, _state(111))
    os.unlink(str(p) + ".sha256")
    with pytest.raises(CheckpointCorruptError, match="sidecar"):
        restore_pytree(p, _like())


def test_restore_shape_mismatch(tmp_path):
    p = tmp_path / "snap"
    save_pytree(p, _state(111))
    with pytest.raises(CheckpointCorruptError):
        restore_pytree(p, init_state(32, 8, device="cpu"))


def test_relaxed_shapes_gate_trailing_dims(tmp_path):
    p = tmp_path / "snap"
    save_pytree(p, {"a": np.zeros((5, 3), dtype=np.int64)})
    got = restore_pytree(p, {"a": np.zeros((0, 3), dtype=np.int64)},
                         strict_shapes=False)
    assert got["a"].shape == (5, 3)
    with pytest.raises(CheckpointCorruptError):
        restore_pytree(p, {"a": np.zeros((0, 4), dtype=np.int64)},
                       strict_shapes=False)


def test_restore_from_rotation_skips_corrupt_newest(tmp_path):
    rot = tmp_path / "rot"
    mark = 0x0123456789AB
    save_pytree_rotating(rot, _state(1))
    newest = save_pytree_rotating(rot, _state(mark))
    _flip_payload_byte(newest, mark)
    tree, path = restore_pytree_rotating(rot, _like())
    assert int(tree.head_resv[3]) == 1
    assert path.endswith("ckpt-00000001")


def test_rotation_prunes_to_keep(tmp_path):
    rot = tmp_path / "rot"
    for i in range(6):
        save_pytree_rotating(rot, _state(i), keep=3)
    names = sorted(n for n in os.listdir(rot)
                   if not n.endswith(".sha256"))
    assert names == [f"ckpt-{i:08d}" for i in (4, 5, 6)]
    tree, _ = restore_pytree_rotating(rot, _like())
    assert int(tree.head_resv[3]) == 5


def test_rotation_empty_raises(tmp_path):
    with pytest.raises(CheckpointCorruptError, match="no intact"):
        restore_pytree_rotating(tmp_path / "nothing", _like())


# ----------------------------------------------------------------------
# kill during save: no crash point leaves a restorable torn snapshot
# ----------------------------------------------------------------------

class _SimulatedKill(BaseException):
    """Nothing in the save path can swallow it: the in-process stand-in
    for SIGKILL."""


def _kill_hook(stage):
    def hook(s):
        if s == stage:
            raise _SimulatedKill(s)
    return hook


TORN_STAGES = [s for s in ckpt_mod.SAVE_STAGES if s != "done"]


def test_save_stages_equal_jax():
    assert ckpt_mod.SAVE_STAGES == jckpt.SAVE_STAGES


@pytest.mark.parametrize("stage", TORN_STAGES)
def test_kill_during_save_restores_previous_intact(tmp_path, stage):
    rot = tmp_path / "rot"
    save_pytree_rotating(rot, _state(7))
    ckpt_mod._crash_hook = _kill_hook(stage)
    try:
        with pytest.raises(_SimulatedKill):
            save_pytree_rotating(rot, _state(8))
    finally:
        ckpt_mod._crash_hook = None
    tree, path = restore_pytree_rotating(rot, _like())
    assert int(tree.head_resv[3]) == 7, \
        f"kill at {stage} left a restorable torn snapshot"
    assert path.endswith("ckpt-00000001")
    save_pytree_rotating(rot, _state(8))
    tree, _ = restore_pytree_rotating(rot, _like())
    assert int(tree.head_resv[3]) == 8


@pytest.mark.parametrize("stage", TORN_STAGES)
def test_kill_during_inplace_overwrite_keeps_old_snapshot(tmp_path, stage):
    p = tmp_path / "snap"
    save_pytree(p, _state(7))
    ckpt_mod._crash_hook = _kill_hook(stage)
    try:
        with pytest.raises(_SimulatedKill):
            save_pytree(p, _state(8))
    finally:
        ckpt_mod._crash_hook = None
    assert int(restore_pytree(p, _like()).head_resv[3]) == 7
    save_pytree(p, _state(8))
    assert int(restore_pytree(p, _like()).head_resv[3]) == 8
    assert not os.path.exists(str(p) + ".prev")


def test_double_crash_keeps_newest_committed_snapshot(tmp_path):
    """A crash after full commit but before the .prev prune, then a crash
    mid-commit of the next save: the newest committed snapshot wins."""
    p = tmp_path / "snap"
    save_pytree(p, _state(1))
    for stage, mark in (("done", 2), ("data_renamed", 3)):
        ckpt_mod._crash_hook = _kill_hook(stage)
        try:
            with pytest.raises(_SimulatedKill):
                save_pytree(p, _state(mark))
        finally:
            ckpt_mod._crash_hook = None
    assert int(restore_pytree(p, _like()).head_resv[3]) == 2


_SUP: dict = {}


def _sup_job_and_ref():
    if not _SUP:
        # ckpt_every=1: the epoch-1 save always has an intact epoch-0
        # predecessor to land on when it tears
        _SUP["job"] = TS.EpochJob(engine="prefix", n=64, depth=6, ring=10,
                                  epochs=4, m=2, k=32, seed=13,
                                  arrival_lam=1.0, waves=2, ckpt_every=1)
        _SUP["ref"] = TS.run_job(_SUP["job"], device="cpu")
    return _SUP["job"], _SUP["ref"]


@pytest.mark.parametrize("stage", ckpt_mod.SAVE_STAGES)
def test_kill_during_save_then_supervised_resume(tmp_path, stage):
    """A kill inside the epoch-1 save at every stage: a torn save resumes
    from the epoch-0 snapshot, a kill after the commit from the one just
    written; either way the run equals the uninterrupted one."""
    job, ref = _sup_job_and_ref()
    plan = TH.HostFaultPlan(kill_at_save=((1, stage),))
    res = TS.run_supervised(job, tmp_path, plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 1
    want = "ckpt-00000002" if stage == "done" else "ckpt-00000001"
    assert res.resumed_from.endswith(want)
    payload, path = restore_pytree_rotating(
        str(tmp_path / "ckpt"), TS._payload_like(job, "cpu"))
    assert int(payload["epoch"]) == job.epochs
    assert path == rotation_paths(tmp_path / "ckpt")[-1]


def test_corrupted_newest_snapshot_supervised_resume(tmp_path):
    job, ref = _sup_job_and_ref()
    plan = TH.HostFaultPlan(
        corrupt_save_at=(1,),
        kill_at_decisions=(max(3 * ref.decisions // 4, 1),))
    res = TS.run_supervised(job, tmp_path, plan, device="cpu")
    TS.assert_crash_equivalent(res, ref)
    assert res.restarts == 1
    assert res.resumed_from.endswith("ckpt-00000001")


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------

def _jax_state(mark: int):
    st = jax_init_state(16, 8)
    return st._replace(head_resv=st.head_resv.at[3].set(mark))


def test_jax_snapshot_restores_in_the_port(tmp_path):
    p = tmp_path / "snap"
    jckpt.save_pytree(p, _jax_state(0x5A5A))
    got = restore_pytree(p, _like())
    assert_state_matches(got, _jax_state(0x5A5A))
    q = tmp_path / "port"
    save_pytree(q, got)
    assert _sidecar(q) == _sidecar(p)


def test_port_snapshot_restores_in_jax(tmp_path):
    p = tmp_path / "snap"
    save_pytree(p, _state(0x5A5A))
    got = jckpt.restore_pytree(p, jax_init_state(16, 8))
    assert_state_matches(_state(0x5A5A), got)
    q = tmp_path / "jax"
    jckpt.save_pytree(q, got)
    assert _sidecar(q) == _sidecar(p)


def test_tree_order_equals_jax(tmp_path):
    """Dict keys in sorted order, NamedTuples in field order, None no
    leaf: a mixed tree gives the JAX package's leaf order and sidecar."""
    tree = {"zeta": np.arange(3, dtype=np.int32), "alpha": None,
            "mid": (np.int64(7), [np.zeros(2, dtype=bool)]),
            "beta": _state(9)}
    jtree = {"zeta": np.arange(3, dtype=np.int32), "alpha": None,
             "mid": (np.int64(7), [np.zeros(2, dtype=bool)]),
             "beta": _jax_state(9)}
    save_pytree(tmp_path / "a", tree)
    jckpt.save_pytree(tmp_path / "b", jtree)
    assert _sidecar(tmp_path / "a") == _sidecar(tmp_path / "b")
    back = restore_pytree(tmp_path / "b", tree)
    assert back["alpha"] is None and int(back["mid"][0]) == 7
    assert torch.equal(back["beta"].head_resv, tree["beta"].head_resv)


_SPEC = make_spec("churn_storm", total_ids=16, base_lam=1.5,
                  compact_every=1, gens=4, stride=4, life=2, capacity0=4)
TEMPLATE_JOBS = {
    "plain": {},
    "tele": dict(with_hists=True, with_ledger=True, flight_records=8,
                 with_prov=True, with_slo=True),
    "churn": dict(churn=_SPEC, with_slo=True, with_prov=True,
                  with_ledger=True),
}


@pytest.mark.parametrize("name", sorted(TEMPLATE_JOBS))
def test_supervisor_payload_equals_jax(tmp_path, name):
    """The supervisor's restore template, saved by each package: the
    same leaves in the same order, so the same sidecar."""
    kw = dict(n=32, depth=4, ring=8, **TEMPLATE_JOBS[name])
    save_pytree(tmp_path / "port",
                TS._payload_like(TS.EpochJob(**kw), "cpu"))
    jckpt.save_pytree(tmp_path / "jax", JS._payload_like(JS.EpochJob(**kw)))
    assert _sidecar(tmp_path / "port") == _sidecar(tmp_path / "jax")
    with np.load(tmp_path / "port") as a, np.load(tmp_path / "jax") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f])


def test_restored_leaves_keep_template_placement(tmp_path):
    p = tmp_path / "snap"
    tree = {"t": torch.arange(4, dtype=torch.int32),
            "n": np.arange(3, dtype=np.uint64)}
    save_pytree(p, tree)
    got = restore_pytree(p, tree, device="cpu")
    assert torch.is_tensor(got["t"]) and got["t"].dtype == torch.int32
    assert isinstance(got["n"], np.ndarray) and got["n"].dtype == np.uint64
    want = jckpt.restore_pytree(p, {"t": jnp.zeros(4, jnp.int32),
                                    "n": np.zeros(3, np.uint64)})
    assert np.array_equal(np.asarray(want["t"]), got["t"].numpy())
