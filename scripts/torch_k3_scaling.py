"""Kernel K3's device time against the shape of its input, for one tree.

K3 (``dmclock_tpu_torch/engine/csrc/ingest_scan.cu``) scans an op
batch's reactivating rows a tile at a time and walks serially from the
first row it cannot scan.  This script times one call of
``kernels.ingest_scan`` (CUDA events around replays of a CUDA graph of
20 calls, ``chip_smoke.cuda_ms``) on:

- ``scan``: rows that never leave the scan (``tests/test_torch_cases.py``
  ``k3_rows``) at counts of 0, 1 and 1 to 8 of K3's tiles: the launch,
  the fixed cost of a tile and its cost a row;
- ``walk``: the same rows with row 0's tag leaving the set again at the
  last row, so every later row is walked: the walk's cost a row;
- ``real``: ``chip_smoke.py`` phase 4b's queue flush and cluster wave
  (``k3_real_batches``), K3's input taken from their ingests on the card.

It imports ``dmclock_tpu_torch`` from ``--root`` (default: the checkout
it lies in), so it times another tree unpacked beside this one (``git
archive`` of a parent commit) on the same inputs, from this checkout's
``tests/test_torch_cases.py`` and ``chip_smoke.py``.  It needs the card
and prints one JSON line with the card's name and power limit.

    python3 scripts/torch_k3_scaling.py [--root DIR]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose dmclock_tpu_torch is timed")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k3_scaling: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(a.root), os.path.join(HERE, "tests")]
    spec = importlib.util.spec_from_file_location(
        "_k3_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import test_torch_cases as tc
    from dmclock_tpu_torch.engine import bridge, kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def time_ms(rows, r: int) -> float:
        x = torch.from_numpy(rows).cuda() if not torch.is_tensor(rows) \
            else rows
        c = torch.tensor(r, device="cuda")
        return cs.cuda_ms(lambda: kernels.ingest_scan(x, c), 20)

    out = {"root": os.path.abspath(a.root), "card": card,
           "tile": tc.K3_TILE, "scan": {}, "walk": {}, "real": {}}
    for r in (0, 1) + tuple(t * tc.K3_TILE for t in (1, 2, 4, 8)):
        out["scan"][r] = time_ms(tc.k3_rows(r, max(r, 1), 24), r)
    for r in (64, 256, 1024, 4096):
        rows = tc.k3_rows(r, r, 24)
        rows[4, 0], rows[6, 0] = 1, r - 1
        out["walk"][r] = time_ms(rows, r)
    seen, real = [], kernels.ingest_scan

    def record(rows, count):
        seen.append((rows.clone(), int(count)))
        return real(rows, count)

    for label, arrays, ops in cs.k3_real_batches():
        kernels.ingest_scan = record
        try:
            kernels.ingest(bridge.state_from_numpy(arrays, "cuda"),
                           torch.from_numpy(ops).cuda(), anticipation_ns=0)
        finally:
            kernels.ingest_scan = real
        rows, r = seen.pop()
        out["real"][label] = {"rows": r, "ms": time_ms(rows, r)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
