"""The scoring, serving and training paths import nothing beyond JAX, numpy,
scipy, optax, chex and einops: each module is imported in a fresh process
whose import system refuses pandas, orbax, torch and tqdm."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

REFUSE = ("pandas", "orbax", "torch", "tqdm")

PROBE = """
import importlib, importlib.abc, sys
REFUSED = {refused!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
importlib.import_module({module!r})
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("ok")
"""


@pytest.mark.parametrize("module", [
    "plantcaduceus_tpu.cli.zero_shot_score",
    "plantcaduceus_tpu.cli.pretrain",
    "plantcaduceus_tpu.engine.server",
    "plantcaduceus_tpu.engine.runner",
    "plantcaduceus_tpu.train.loop",
    "plantcaduceus_tpu.train.checkpoint",
    "plantcaduceus_tpu.ops.triton_scan",
])
def test_module_imports_only_the_sure_packages(module):
    code = PROBE.format(refused=REFUSE, module=module)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PCAD_PLATFORM": "cpu",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
