"""PyTorch port: the package and chip_smoke.py stand apart from the
reference package and from its framework.

In a fresh interpreter where importing the reference's framework or
package fails, every module of paddle_tpu_torch and chip_smoke.py still
imports; and no file of the package, nor chip_smoke.py, names either.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "paddle_tpu_torch"
FRAMEWORK = "ja" + "x"            # spelled apart so this file is no match itself

_CHILD = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["{fw}"] = None
sys.modules["paddle_tpu"] = None
sys.path.insert(0, {root!r})
import paddle_tpu_torch
names = ["paddle_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "{fw}" or m.startswith("{fw}.")
       or m == "paddle_tpu" or m.startswith("paddle_tpu."))]
print(len(names), bad)
"""


def _modules():
    import paddle_tpu_torch

    return ["paddle_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")]


def test_every_module_imports_without_the_reference():
    code = _CHILD.format(fw=FRAMEWORK, root=str(ROOT),
                         smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(count) == len(_modules()) >= 12
    assert bad == "[]"


def test_no_file_names_the_reference():
    files = sorted(p for p in PACKAGE.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh", ".h")
                   and "_build" not in p.parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 14
    pattern = re.compile(rf"(\bpaddle_tpu\.|{FRAMEWORK})", re.IGNORECASE)
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []
