"""Time ``chip_smoke.py`` phase 14's f32 training run for one or more
checkouts of the port, one after another, on one GPU.

Usage, from the root of a checkout on a machine with a card::

    python -m paddle_tpu_torch.tools.train_ab DIR [DIR ...]

Each DIR is the root of a checkout (this one is ``.``); an older one
unpacked with ``git archive`` into a git-ignored directory compares a
parent commit with this one (give them as parent, new, new, parent). Each
runs in a child process of its own with DIR's package first on
``sys.path``: it builds that package's kernels and runs this checkout's
``chip_smoke.train(0, f32=True, count=False)`` on it, the same model,
optimizer, batches, timed steps and profiled step as phase 14, with the
device time split by ``chip_smoke.KERNEL_KINDS``. It reads no launch
counter, so any version of the package can be timed.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHIP_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"

CHILD = r"""
import importlib.util, json, sys, time
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {chip_smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from paddle_tpu_torch.ops import _build
t0 = time.perf_counter()
_build.build()
build_s = time.perf_counter() - t0
res = cs.train(0, f32=True, count=False)
print(json.dumps({{"root": {root!r}, "build_s": round(build_s, 2), **res}}), flush=True)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for root in argv:
        code = CHILD.format(root=str(Path(root).resolve()), chip_smoke=str(CHIP_SMOKE))
        proc = subprocess.run([sys.executable, "-c", code], text=True, cwd=root, timeout=1800,
                              capture_output=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            rc = 1
            print(json.dumps({"root": root, "failed": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
    print(smi, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
