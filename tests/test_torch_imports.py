"""Import hygiene: the port and chip_smoke.py never import JAX or cs_vit_tpu,
and importing them loads none of the file libraries (h5py, cv2,
tensorboardX, safetensors, matplotlib) that the card's machine may lack: the functions
that read or write those formats import them. Nor does importing them build
or load the C crop (``cs_vit_tpu_torch.native``): it is built at first use.
Nor does importing them start a ``torch.distributed`` process group:
``parallel.init_distributed`` does that, when an entry point calls it.

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cs_vit_tpu", "h5py", "cv2",
                                    "tensorboardX", "safetensors", "matplotlib"))
assert not bad, bad
import torch.distributed as dist
assert not dist.is_initialized()
native = sys.modules.get("cs_vit_tpu_torch.native")
assert native is None or native._loaded == {{}}, native._loaded
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
    out = _run(_CHECK.format(imports=imports, count="' '.join(mods)"))
    mods = set(out.split()[1:])
    assert len(mods) >= 15  # every module of the package was imported
    for name in ("native", "parallel", "parallel.prefetch", "ops.heatmap", "data.ho3d",
                 "data.ho3d_fs", "data.ih26m_seq", "data.ih26m_legacy",
                 "data.ih26m_legacy_aug", "data.mano_gt", "data.fixtures", "parallel.mesh",
                 "models.vit", "models.dinov2", "models.ti", "train.sparse_update",
                 "data.pretrain", "cli.pretrain_ti", "utils.misc", "utils.vis",
                 "parallel.tp", "parallel.sync_norm", "tools.demo", "tools.analyze_eval_h5",
                 "tools.scan_ih26m_annotations", "tools.dryrun_dexycb",
                 "tools.dryrun_hybrid", "tools.probe_overlap", "ops.probe_overlap"):
        assert f"cs_vit_tpu_torch.{name}" in mods, name


@pytest.mark.parametrize("module", ["chip_smoke"])
def test_root_scripts_import_without_jax(module):
    _run(_CHECK.format(imports=f"import {module}\nimport cs_vit_tpu_torch.serving", count=1))


@pytest.mark.parametrize("entry", [
    "cli.finetune:main", "cli.evaluate:main", "cli.pretrain_ti:main", "serving:PoserSession",
    "tools.probe_overlap:run", "cli.finetune:build_argparser", "cli.pretrain_ti:build_argparser",
    "tools.demo:build_argparser",
])
def test_entry_points_default_to_the_card(entry):
    """Every entry point runs on the card unless the caller asks for the CPU."""
    import importlib
    import inspect

    mod, name = entry.split(":")
    fn = getattr(importlib.import_module(f"cs_vit_tpu_torch.{mod}"), name)
    if name == "build_argparser":
        assert fn().get_default("device") == "cuda"
    else:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
