"""Import hygiene: the port and chip_smoke.py never import JAX or cs_vit_tpu.

Each check runs in a fresh interpreter, so nothing the test session already
imported can hide an import.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
{imports}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cs_vit_tpu"))
assert not bad, bad
print("ok", {count})
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_every_port_module_imports_without_jax():
    imports = (
        "import cs_vit_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(cs_vit_tpu_torch.__path__, "
        "'cs_vit_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
    )
    out = _run(_CHECK.format(imports=imports, count="len(mods)"))
    assert int(out.split()[-1]) >= 15  # every module of the slice was imported


@pytest.mark.parametrize("module", ["chip_smoke"])
def test_root_scripts_import_without_jax(module):
    _run(_CHECK.format(imports=f"import {module}\nimport cs_vit_tpu_torch.serving", count=1))
