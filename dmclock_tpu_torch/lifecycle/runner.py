"""Serial-engine churn runner: the lifecycle digest gate's oracle leg.

Counterpart of ``dmclock_tpu/lifecycle/runner.py``.  Runs a churn spec
on the exact serial engine (``kernels.engine_run``, the oracle every
epoch engine is held to), with the boundary grid, the RNG consumption
and the canonical client-id-space chain digest of the JAX package's
runner, so the digest of a port run equals the JAX digest of the same
run, and a dynamic spec's digest equals its static variant's.  The
ingest leg is the captured ``stream.jit_ingest_step``, as in the JAX
runner, and the serial leg the JAX runner's ``_RUN_JIT[steps]`` (a bare
``jax.jit`` of ``engine_run``): ``kernels.serial_leg``, captured blocks
outside the compile plane's records.
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..engine import kernels
from ..engine.state import init_state
from ..engine.stream import jit_ingest_step
from ..robust.digest import digest_update
from . import churn as churn_mod
from .plane import LifecyclePlane


def run_serial_churn(spec: dict, *, epochs: int, every: int = 2,
                     steps: int = 16, ring: int = 16, waves: int = 2,
                     dt_epoch_ns: int = 10 ** 8, seed: int = 11,
                     plane: LifecyclePlane = None,
                     device: str | torch.device = DEFAULT_DEVICE):
    """Run ``spec`` for ``epochs`` on the serial engine, with a boundary
    every ``every`` epochs.  Returns ``(digest_hex, plane, decisions)``:
    the canonical client-id-space chain digest, comparable across the
    dynamic spec and its :func:`~.churn.static_variant` and with the JAX
    package's runner.  ``plane`` may be passed in (e.g. pre-loaded with
    accepted control ops)."""
    dev = resolve_device(device)
    if plane is None:
        plane = LifecyclePlane(spec)
    state = init_state(spec["capacity0"], ring, device=dev)
    rng = np.random.Generator(np.random.PCG64(seed))
    ingest = jit_ingest_step(dt_epoch_ns=dt_epoch_ns, waves=waves)
    run = kernels.serial_leg(steps, allow_limit_break=False,
                             anticipation_ns=0)
    digest = b"\x00" * 32
    decisions = 0
    for e in range(epochs):
        if e % every == 0:
            state, _ = plane.boundary(state, e, every)
        lam = churn_mod.lam_vector(spec, e)
        raw = rng.poisson(lam).astype(np.int32)
        t_base = e * dt_epoch_ns
        counts = torch.from_numpy(plane.map_counts(raw)).to(dev)
        state = ingest(state, counts, t_base)
        state, _, d = run(state, t_base + dt_epoch_ns)
        dtype = d.type.cpu().numpy()
        dec = SimpleNamespace(type=dtype, phase=d.phase.cpu().numpy(),
                              cost=d.cost.cpu().numpy())
        dec.slot = plane.slots.translate(d.slot.cpu().numpy())
        decisions += int((dtype == kernels.RETURNING).sum())
        digest = digest_update(digest, (dec,))
    return hashlib.sha256(digest).hexdigest(), plane, decisions
