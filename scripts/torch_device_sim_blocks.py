"""The device sim's headline op by op and through its program at each
prefix block size, in one process (PyTorch port).

    python3 scripts/torch_device_sim_blocks.py [--blocks 1,2,3,4]
        [--reps 2] [--n 100000] [--device cuda]

Runs ``sim.device_sim.device_sim_headline`` (100,000 clients on 8
servers by default) op by op (``device_sim_step``, one read back a
serve batch) and through ``jit_device_sim_step`` at each ``--blocks``
size (prefix batches a server's captured block holds), ``--reps``
times in turn, and prints one JSON line a run: the card's name and
power limit, ms a slice, ops per wall second, read backs a slice and
the prefix batches launched and in a server's loop a slice.  The
programs' captures are dropped after each run.  The default block
(``PREFIX_BLOCK``) is the size these rows put first.  On the CPU
(``--device cpu --n 64``) it runs the same rows at a cut width.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", default="1,2,3,4")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from dmclock_tpu_torch.obs import compile_plane
    from dmclock_tpu_torch.sim import device_sim as DS

    dev = torch.device(a.device)
    card = str(dev)
    if dev.type == "cuda":
        from dmclock_tpu_torch.engine import _ext

        _ext.build()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    blocks = [None] + [int(b) for b in a.blocks.split(",")]
    for rep in range(a.reps):
        for block in blocks:
            t0 = time.perf_counter()
            row = DS.device_sim_headline(
                a.n, device=dev, program=block is not None,
                block=block or DS.PREFIX_BLOCK)
            print(json.dumps(dict(
                card=card, rep=rep, block=block,
                wall_s=time.perf_counter() - t0,
                **{k: row[k] for k in (
                    "ms_per_slice", "ops_per_sec", "read_backs_per_slice",
                    "prefix_batches_per_slice", "prefix_live_per_slice",
                    "weight_ratio_3_1", "total_ops")})), flush=True)
            compile_plane.clear_compiled()
            DS._STEP_JIT_CACHE.clear()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
