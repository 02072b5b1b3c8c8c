"""Time ``chip_smoke.py`` phase 21c's epoch (ResNet-50 f32 on the Flowers
surrogate through ``Model.fit``, batch 64 at 224², the loader's workers
forked at the epoch's start) under several loader settings, one after
another in one process on one GPU, to see what the workers cost the
parent's host work as the parent grows.

Usage, from the root of a checkout on a machine with a card::

    python -m paddle_tpu_torch.tools.fit_ab 4 0 +8 4 0 freeze 4

Each argument, in order: a number runs one epoch with that many worker
processes (``chip_smoke.flowers_epoch``: a fresh model from seed 0);
``+G`` makes this process hold G GiB more of small Python objects, as a
long-lived trainer holds (``chip_smoke.py``'s own process after its
earlier phases); ``freeze`` calls ``gc.freeze()``, so the collector no
longer walks (and writes to) the objects held so far. Each epoch prints
one JSON line: workers, the process's resident memory, ms a step and the
consumer's wait for the loader over the steps after the warm-up, the
device's busy share and the first batch's wait.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

CHIP_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops import _build

    _build.build()
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    held = []
    for arg in argv:
        if arg == "freeze":
            gc.freeze()
            continue
        if arg.startswith("+"):
            t0 = time.perf_counter()
            gc.disable()        # no collections while the objects are made
            # about 100 bytes an object: a one-element list and its int
            held.append([[i] for i in range(int(float(arg[1:]) * 2**30 / 100))])
            gc.enable()
            print(json.dumps({"held_gib": float(arg[1:]), "rss_gib": round(cs.host_rss_gib(), 3),
                              "s": round(time.perf_counter() - t0, 1)}), flush=True)
            continue
        ep = cs.flowers_epoch(0, int(arg))
        timed = ep["timed"]
        print(json.dumps({"workers": int(arg), "rss_gib": round(cs.host_rss_gib(), 3),
                          "gc_frozen": gc.get_freeze_count(),
                          "step_ms": round(1e3 * ep["step_s"], 3),
                          "loader_wait_ms_per_step": round(1e3 * ep["wait_s"] / timed, 3),
                          "device_busy_share": round(ep["busy_s"] / ep["window_s"], 4),
                          "first_batch_wait_s": round(ep["first_wait_s"], 3)}), flush=True)
        del ep
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
