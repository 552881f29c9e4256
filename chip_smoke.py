"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

1. the card: name and power limit (``nvidia-smi``), device name;
2. build the port's CUDA kernel from the source in this checkout;
3. hold kernel K1 (the ring window) bit for bit against its plain
   PyTorch version at the serve shape and odd shapes, and time it beside
   its memory bound, the plain version and ``torch.gather``;
4. exactness: at a small shape the prefix-commit epochs' decision
   stream and final state equal the port's own serial engine;
5. the main path: ``serve_only`` at the ``serve`` workload's full width
   (100,000 clients, a 320-slot ring, m=32 batches of up to k=65536
   decisions), with K1's launch count reset just before and read just
   after; its first decisions are held against the serial engine at
   full width; then the epochs are timed on the card.

Prints the kernel table as one JSON line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

N_SERVE, DEPTH, K_SERVE, M_SERVE, EPOCHS = 100_000, 320, 65536, 32, 3
TIMED_EPOCHS = 5
SERIAL_CHECK_STEPS = 512
RW_SHAPES = [(100_000, 320, 32), (700, 16, 5), (2500, 128, 32),
             (100, 64, 64), (1000, 320, 320), (333, 48, 17)]
K1_SOURCE = "dmclock_tpu_torch/engine/csrc/ring_window.cu"
K1_REPLACES = "dmclock_tpu/engine/fastpath.py:156"

# device-memory rate of the H100 SXM (bytes/s, NVIDIA's data sheet),
# for the bound of a data-movement kernel
MEM_RATE = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    if "H100" not in name or "PCIe" in name or "NVL" in name:
        raise RuntimeError(f"{name!r} is not an H100 SXM: the bounds "
                           f"below use its memory rate")
    log(f"[card] torch.cuda.get_device_name(0) = {name}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    return smi


def phase_build(ext) -> None:
    t0 = time.perf_counter()
    lib = ext.build()
    log(f"[build] {lib.name} built in "
        f"{time.perf_counter() - t0:.3f} s")


def phase_k1(fp, card: str) -> dict:
    """K1 against its plain version; time at the serve shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0
    for n, q, w in RW_SHAPES:
        arr = torch.randint(-(1 << 50), 1 << 50, (n, q), generator=gen,
                            device=dev, dtype=torch.int64)
        cost = torch.randint(1, 1 << 20, (n, q), generator=gen,
                             device=dev, dtype=torch.int64)
        q0 = torch.randint(0, q, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
        q0[: min(n, 3)] = q - 1                      # the wrap edge
        ka, kc = fp.ring_window_rows(arr, cost, q0, w)
        pa = fp._ring_window_torch(arr, q0, w)
        pc = fp._ring_window_torch(cost, q0, w)
        torch.cuda.synchronize()
        err = max(int((ka - pa).abs().max()), int((kc - pc).abs().max()))
        if ka.shape != (w, n) or not (torch.equal(ka, pa)
                                      and torch.equal(kc, pc)):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"N={n} Q={q} w={w}: max err {err}")
        max_err = max(max_err, err)
        log(f"[k1] N={n} Q={q} w={w}: bit-identical to the plain version")

    n, q, w = RW_SHAPES[0]
    arr = torch.randint(0, 1 << 40, (n, q), generator=gen, device=dev,
                        dtype=torch.int64)
    cost = torch.randint(1, 4, (n, q), generator=gen, device=dev,
                         dtype=torch.int64)
    q0 = torch.randint(0, q, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    idx_t = torch.remainder(
        q0.to(torch.int64)[None, :]
        + torch.arange(w, device=dev, dtype=torch.int64)[:, None], q)
    k_ms = cuda_ms(lambda: fp.ring_window_rows(arr, cost, q0, w), 50)
    p_ms = cuda_ms(lambda: (fp._ring_window_torch(arr, q0, w),
                            fp._ring_window_torch(cost, q0, w)), 20)
    # the library yardstick: torch.gather on the transposed ring views
    # with a precomputed [w, N] index, once per ring
    l_ms = cuda_ms(lambda: (torch.gather(arr.T, 0, idx_t),
                            torch.gather(cost.T, 0, idx_t)), 20)
    nbytes = 2 * (2 * n * w * 8) + 4 * n
    bound_ms = nbytes / MEM_RATE * 1e3
    log(f"[k1] N={n} Q={q} w={w} on {card}: kernel {k_ms:.6f} ms, "
        f"bound {bound_ms:.6f} ms ({nbytes} bytes), plain {p_ms:.6f} ms, "
        f"torch.gather x2 {l_ms:.6f} ms")
    return dict(name="ring_window", route="cuda", source=K1_SOURCE,
                replaces=K1_REPLACES, launches=None, max_abs_err=max_err,
                ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=l_ms)


def _serial_matches(kernels, st0, now, slots, phases, costs, what: str,
                    final_state=None) -> None:
    """``slots``/``phases``/``costs``: the prefix path's committed stream
    (1-d); the serial engine from ``st0`` must make exactly these."""
    steps = int(slots.shape[0])
    st, _, ser = kernels.engine_run(st0, now, steps,
                                    allow_limit_break=False,
                                    anticipation_ns=0)
    if not bool((ser.type == kernels.RETURNING).all()):
        raise AssertionError(f"{what}: serial engine stopped serving")
    for name, a, b in (("slot", slots, ser.slot),
                       ("phase", phases.to(torch.int32), ser.phase),
                       ("cost", costs.to(torch.int64), ser.cost)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} stream differs from "
                                 f"the serial engine")
    if final_state is not None:
        for f, a, b in zip(st._fields, final_state, st):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: state field {f} differs "
                                     f"from the serial engine")
    log(f"[exact] {what}: {steps} decisions equal the serial engine"
        + (" and so does the final state" if final_state is not None
           else ""))


def phase_exact(serve, fp, kernels) -> None:
    # weight phase only; then both phases (every reservation tag
    # eligible at 20 ms, the weight phase after they are served)
    for n, now in ((256, 0), (128, 20_000_000)):
        st0 = serve._preloaded_state(n, 8, ring=8, device="cuda")
        ep = fp.scan_prefix_epoch(st0, now, 4, 64, anticipation_ns=0,
                                  with_metrics=True)
        if not bool(ep.guards_ok.all()):
            raise AssertionError("exactness phase: a guard tripped")
        served = ep.slot >= 0
        if int(served.sum()) != int(ep.count.sum()) or \
                int(ep.count.sum()) == 0:
            raise AssertionError("exactness phase: bad committed count")
        _serial_matches(kernels, st0, now, ep.slot[served],
                        ep.phase[served], ep.cost[served],
                        f"{n} clients, depth 8, k=64, m=4, now={now}, "
                        f"phases {sorted(set(ep.phase[served].tolist()))}",
                        final_state=ep.state)


def phase_serve(serve, kernels, ext, obsdev, card: str) -> int:
    ext.reset_launches()
    res = serve.serve_only(N_SERVE, DEPTH, K_SERVE, M_SERVE, EPOCHS,
                           device="cuda")
    torch.cuda.synchronize()
    launches = dict(ext.LAUNCHES)
    log(f"[serve] kernel launches on the main path: {launches}")
    if launches["ring_window"] != EPOCHS:
        raise AssertionError(f"K1 launched {launches['ring_window']} "
                             f"times over {EPOCHS} epochs")
    total = int(res.count.sum())
    met = obsdev.metrics_dict(res.metrics)
    if not bool(res.guards_ok.all()):
        raise AssertionError("serve: a rebase guard tripped")
    if met["decisions_total"] != total:
        raise AssertionError(f"serve: metrics say {met['decisions_total']}"
                             f" decisions, counts say {total}")
    if total < EPOCHS * K_SERVE:
        raise AssertionError(f"serve: only {total} decisions")
    if res.slot.shape != (EPOCHS, M_SERVE, K_SERVE):
        raise AssertionError(f"serve: slot shape {tuple(res.slot.shape)}")
    if int(res.slot.min()) < -1 or int(res.slot.max()) >= N_SERVE:
        raise AssertionError("serve: a slot outside the population")
    log(f"[serve] {EPOCHS} epochs: {total} decisions, per-batch counts "
        f"min {int(res.count.min())} max {int(res.count.max())}, "
        f"every guard held; metrics {json.dumps(met)}")

    # the first decisions of the full-width run against the serial
    # engine, from the same preloaded state
    st0 = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH,
                                 device="cuda")
    served = res.slot[0] >= 0
    steps = SERIAL_CHECK_STEPS
    _serial_matches(kernels, st0, 0, res.slot[0][served][:steps],
                    res.phase[0][served][:steps],
                    res.cost[0][served][:steps],
                    f"full width N={N_SERVE}, first {steps} decisions")
    del res, st0

    # timing: each epoch between CUDA events, state built beforehand
    st = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH, device="cuda")
    st = serve.serve_epochs(st, 1, k=K_SERVE, m=M_SERVE).state  # warm
    torch.cuda.synchronize()
    ms, decisions = [], []
    for _ in range(TIMED_EPOCHS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        r = serve.serve_epochs(st, 1, k=K_SERVE, m=M_SERVE)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        st = r.state
        ms.append(start.elapsed_time(end))
        decisions.append(int(r.count.sum()))
        if not bool(r.guards_ok.all()) or decisions[-1] < K_SERVE:
            raise AssertionError(f"serve: a timed epoch committed "
                                 f"{decisions[-1]} decisions or tripped "
                                 f"a guard")
        if obsdev.metrics_dict(r.metrics)["decisions_total"] \
                != decisions[-1]:
            raise AssertionError("serve: a timed epoch's metrics "
                                 "disagree with its counts")
        log(f"[serve] epoch: {decisions[-1]} decisions in {ms[-1]:.3f} ms "
            f"(events), {host_ms:.3f} ms (host clock)")
    med = statistics.median(ms)
    rate = sum(decisions) / (sum(ms) / 1e3)
    log(f"[serve] on {card}: N={N_SERVE} Q={DEPTH} k={K_SERVE} "
        f"m={M_SERVE}: median epoch {med:.3f} ms over {TIMED_EPOCHS}, "
        f"{rate:.1f} decisions/s")
    return launches["ring_window"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.engine import _ext, fastpath, kernels
    from dmclock_tpu_torch.obs import device as obsdev

    card = phase_card()
    phase_build(_ext)
    k1 = phase_k1(fastpath, card)
    phase_exact(serve, fastpath, kernels)
    k1["launches"] = phase_serve(serve, kernels, _ext, obsdev, card)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
