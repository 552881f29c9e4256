"""Where the time of one ``serve`` epoch goes on the card (PyTorch port).

    python3 scripts/torch_serve_profile.py [--n 100000] [--epochs 1]

Builds the ``serve`` workload's preloaded state (``dmclock_tpu_torch.
serve``), runs one warm-up epoch, then traces ``--epochs`` epochs with
``torch.profiler`` (CPU and CUDA activities).  Prints, on the card it
ran on: the host wall time, the device busy time (the union of kernel
intervals) and so the device idle share, the number of kernel launches,
and the operators that take most device time.  The full table goes to
``chiprun_out/serve_profile.txt``.  Needs CUDA; exits non-zero without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--depth", type=int, default=320)
    ap.add_argument("--k", type=int, default=65536)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "serve_profile.txt"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs CUDA", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dmclock_tpu_torch import serve
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    st = serve._preloaded_state(a.n, a.depth, ring=a.depth, device="cuda")
    st = serve.serve_epochs(st, 1, k=a.k, m=a.m).state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve.serve_epochs(st, a.epochs, k=a.k, m=a.m)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    decisions = int(res.count.sum())
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in kernels)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(f"{card}\n{table}\n")
    top = sorted(prof.key_averages(),
                 key=lambda e: -e.self_device_time_total)[:12]
    print(table)
    print(json.dumps({
        "card": card, "n": a.n, "k": a.k, "m": a.m, "epochs": a.epochs,
        "decisions": decisions, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernel_launches": len(kernels),
        "top_device_ms": {e.key: e.self_device_time_total / 1e3
                          for e in top}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
