"""Host-level fault plans: the failures that kill the host half of a
run (the port of ``dmclock_tpu/robust/host_faults.py``; the plan format
is the JAX package's, so a plan JSON loads in either).

- **kill by decision count** (``kill_at_decisions``): kill the runner
  the first time the cumulative decision total crosses a point, between
  two rotation checkpoints;
- **kill during a checkpoint save** (``kill_at_save``): die inside
  ``utils.checkpoint.save_pytree`` at a named ``_crash_hook`` stage of a
  given epoch's save, the torn snapshots the atomic save exists for;
- **checkpoint corruption during save** (``corrupt_save_at``): the save
  commits, then payload bytes rot under it (flipped through the
  ``_post_commit_hook`` seam); a resume must fall back past it;
- **scrape-port loss** (``drop_scrape_at``): the metrics endpoint
  vanishes at an epoch boundary and the runner rebinds it;
- **kill inside a controller decision** (``kill_at_controller``): die
  at a ``CONTROLLER_STAGES`` point of a closed-loop controller decision
  (before its journal write, after it, or after the knobs moved).

Plans are host data sampled once from a seed (PCG64, the same draws as
the JAX package) or built by hand; the empty plan
(:func:`zero_host_plan`) leaves a supervised run bit-identical to the
bare runner.

:class:`HostFaultInjector` arms a plan against a live job loop.  Every
point fires exactly once across restarts: its id is appended to the
``host_faults.fired`` journal (flush + fsync) before the kill, so a
resumed process replaying the same decisions skips it.
"""

from __future__ import annotations

import os
import signal
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..utils import checkpoint as ckpt_mod


# The controller's journal-then-apply sequence exposes three named
# kill points per decision: before the journal line is durable, after
# it but before the apply, and after the knob vector moved.
CONTROLLER_STAGES = ("before_journal", "after_journal", "after_apply")


class HostKill(BaseException):
    """In-process stand-in for SIGKILL (a BaseException, so no
    ``except Exception`` inside the job can swallow it) -- what the
    trampoline-mode injector raises at a plan point."""


class HostFaultPlan(NamedTuple):
    """Deterministic host fault schedule.  All fields are tuples of
    plain ints/strs so a plan JSON-round-trips into the spawn-mode
    child process unchanged."""

    kill_at_decisions: Tuple[int, ...] = ()
    # (epoch, stage) pairs; stage from utils.checkpoint.SAVE_STAGES
    kill_at_save: Tuple[Tuple[int, str], ...] = ()
    corrupt_save_at: Tuple[int, ...] = ()     # epochs whose save rots
    drop_scrape_at: Tuple[int, ...] = ()      # epochs losing the port
    # (epoch, stage) pairs; stage from CONTROLLER_STAGES -- die inside
    # the controller's journal-then-apply sequence at that boundary
    kill_at_controller: Tuple[Tuple[int, str], ...] = ()


def zero_host_plan() -> HostFaultPlan:
    """The empty plan: supervisor-wrapped must be bit-identical to the
    bare runner under it."""
    return HostFaultPlan()


def host_plan_events(plan: Optional[HostFaultPlan]) -> dict:
    """Host-side ground truth of what a full run of ``plan`` injects
    (the oracle the supervisor's restart accounting is checked
    against: every kill point is one restart, corruption alone kills
    nothing)."""
    if plan is None:
        return {"kills": 0, "save_kills": 0, "corrupt_saves": 0,
                "scrape_drops": 0, "ctl_kills": 0, "restarts": 0}
    kills = len(plan.kill_at_decisions)
    save_kills = len(plan.kill_at_save)
    ctl_kills = len(getattr(plan, "kill_at_controller", ()))
    return {
        "kills": kills,
        "save_kills": save_kills,
        "corrupt_saves": len(plan.corrupt_save_at),
        "scrape_drops": len(plan.drop_scrape_at),
        "ctl_kills": ctl_kills,
        "restarts": kills + save_kills + ctl_kills,
    }


def describe_host(plan: Optional[HostFaultPlan]) -> str:
    """Compact tag of a plan: ``"none"`` for no or an empty plan, else
    a summary naming the fault mix (the JAX package's tags)."""
    ev = host_plan_events(plan)
    if sum(ev.values()) == 0:
        return "none"
    tag = (f"host:kill{ev['kills']}+savekill{ev['save_kills']}"
           f"+corrupt{ev['corrupt_saves']}+scrape{ev['scrape_drops']}")
    if ev["ctl_kills"]:
        tag += f"+ctlkill{ev['ctl_kills']}"
    return tag


def sample_host_plan(seed: int, *, epochs: int, est_decisions: int,
                     kills: int = 1, save_kills: int = 0,
                     corrupt_saves: int = 0, scrape_drops: int = 0,
                     ckpt_every: int = 2) -> HostFaultPlan:
    """Sample a deterministic plan from ``seed`` (PCG64; stable across
    runs and platforms).  ``est_decisions`` bounds the kill-point
    draw; kill points land strictly inside the run so the final state
    still differs from the fresh one when a kill fires.  Save-stage
    faults target epochs that actually checkpoint (multiples of
    ``ckpt_every``, matching the supervisor's boundary rule)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    lo = max(est_decisions // 8, 1)
    hi = max(est_decisions - lo, lo + 1)
    kill_pts = tuple(sorted(int(x) for x in
                            rng.integers(lo, hi, size=kills)))
    save_epochs = [e for e in range(epochs)
                   if (e + 1) % max(ckpt_every, 1) == 0]
    stages = [s for s in ckpt_mod.SAVE_STAGES if s != "done"]
    saves = tuple(
        (int(rng.choice(save_epochs)), str(rng.choice(stages)))
        for _ in range(save_kills)) if save_epochs else ()
    corrupt = tuple(int(rng.choice(save_epochs))
                    for _ in range(corrupt_saves)) if save_epochs \
        else ()
    drops = tuple(int(x) for x in
                  rng.integers(0, max(epochs, 1), size=scrape_drops))
    return HostFaultPlan(kill_at_decisions=kill_pts,
                         kill_at_save=saves,
                         corrupt_save_at=corrupt,
                         drop_scrape_at=drops)


def plan_to_json(plan: Optional[HostFaultPlan]) -> dict:
    if plan is None:
        plan = zero_host_plan()
    return {"kill_at_decisions": list(plan.kill_at_decisions),
            "kill_at_save": [[int(e), str(s)]
                             for e, s in plan.kill_at_save],
            "corrupt_save_at": list(plan.corrupt_save_at),
            "drop_scrape_at": list(plan.drop_scrape_at),
            "kill_at_controller": [[int(e), str(s)]
                                   for e, s in plan.kill_at_controller]}


def plan_from_json(obj: dict) -> HostFaultPlan:
    return HostFaultPlan(
        kill_at_decisions=tuple(int(x)
                                for x in obj.get("kill_at_decisions",
                                                 ())),
        kill_at_save=tuple((int(e), str(s))
                           for e, s in obj.get("kill_at_save", ())),
        corrupt_save_at=tuple(int(x)
                              for x in obj.get("corrupt_save_at", ())),
        drop_scrape_at=tuple(int(x)
                             for x in obj.get("drop_scrape_at", ())),
        kill_at_controller=tuple(
            (int(e), str(s))
            for e, s in obj.get("kill_at_controller", ())))


class HostFaultInjector:
    """Arms a :class:`HostFaultPlan` against a running job loop.

    ``kill_mode="raise"`` (the in-process trampoline) raises
    :class:`HostKill`; ``kill_mode="sigkill"`` (the child-process
    supervisor) SIGKILLs the interpreter -- the real thing, nothing
    runs after it.  Either way the point id is durably appended to
    ``<workdir>/host_faults.fired`` BEFORE the kill (write-ahead), so
    the point fires exactly once across however many restarts the
    supervisor grants."""

    FIRED_NAME = "host_faults.fired"

    def __init__(self, plan: Optional[HostFaultPlan], workdir: str,
                 kill_mode: str = "raise"):
        assert kill_mode in ("raise", "sigkill"), kill_mode
        self.plan = plan if plan is not None else zero_host_plan()
        self.kill_mode = kill_mode
        self._fired_path = os.path.join(os.fspath(workdir),
                                        self.FIRED_NAME)
        self._fired = set()
        if os.path.exists(self._fired_path):
            with open(self._fired_path) as fh:
                self._fired = {ln.strip() for ln in fh if ln.strip()}

    @property
    def fired(self) -> frozenset:
        return frozenset(self._fired)

    def _mark(self, point: str) -> bool:
        """Durably record ``point`` as fired; False when it already
        was (the replay-after-resume case)."""
        if point in self._fired:
            return False
        self._fired.add(point)
        with open(self._fired_path, "a") as fh:
            fh.write(point + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        return True

    def _kill(self, label: str) -> None:
        if self.kill_mode == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise HostKill(label)

    # -- plan points ---------------------------------------------------
    def after_decisions(self, total: int) -> None:
        """Call with the cumulative decision count after each epoch;
        the first crossing of an unfired kill point dies here."""
        for i, point in enumerate(self.plan.kill_at_decisions):
            if total >= point and self._mark(f"dec:{i}"):
                self._kill(f"kill_at_decisions[{i}]={point} "
                           f"(total {total})")

    def controller_point(self, epoch: int, stage: str) -> None:
        """The controller passes this as its ``fault`` seam: each
        decision fires it at every CONTROLLER_STAGES point.  The first
        unfired matching (epoch, stage) plan entry dies here --
        write-ahead marked, so the resumed incarnation replays the
        boundary instead of dying again."""
        for i, (e, s) in enumerate(self.plan.kill_at_controller):
            if e == epoch and s == stage and self._mark(f"ctl:{i}"):
                self._kill(f"kill_at_controller epoch {epoch} "
                           f"stage {stage}")

    def drop_scrape(self, epoch: int) -> bool:
        """True when this epoch's plan says the scrape port vanishes
        (at most once per planned epoch)."""
        hit = False
        for i, e in enumerate(self.plan.drop_scrape_at):
            if e == epoch and self._mark(f"scrape:{i}"):
                hit = True
        return hit

    def around_save(self, epoch: int, save_fn):
        """Run one checkpoint save under the plan: may die at a named
        ``_crash_hook`` stage, and/or have the committed payload rot
        via ``_post_commit_hook``.  Hooks are module-global, so they
        are always uninstalled on the way out (a HostKill must not
        leak a crash hook into the next save)."""
        kill_stage = None
        for i, (e, stage) in enumerate(self.plan.kill_at_save):
            if e == epoch and f"savekill:{i}" not in self._fired:
                kill_stage, kill_id = stage, f"savekill:{i}"
                break

        def crash_hook(stage):
            if stage == kill_stage and self._mark(kill_id):
                self._kill(f"kill_at_save epoch {epoch} "
                           f"stage {stage}")

        corrupt_id = None
        for i, e in enumerate(self.plan.corrupt_save_at):
            if e == epoch and f"corrupt:{i}" not in self._fired:
                corrupt_id = f"corrupt:{i}"
                break

        def post_commit(path):
            if self._mark(corrupt_id):
                _flip_payload_byte(path)

        if kill_stage is not None:
            ckpt_mod._crash_hook = crash_hook
        if corrupt_id is not None:
            ckpt_mod._post_commit_hook = post_commit
        try:
            return save_fn()
        finally:
            ckpt_mod._crash_hook = None
            ckpt_mod._post_commit_hook = None


def _flip_payload_byte(path: str) -> None:
    """Flip one byte in the middle of a committed snapshot's data file
    (media rot under a just-finished save).  The sidecar is left
    alone, so the pair fails digest verification and restore walks
    back to an older intact rotation entry."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))
        fh.flush()
        os.fsync(fh.fileno())
