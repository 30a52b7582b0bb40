"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``, nor ``msgpack``
(absent on the card's machine; the port's checkpoints are npz + JSON)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_import_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch, repro_torch.core.als_device, "
            "repro_torch.convert, repro_torch.kernels.build, "
            "repro_torch.methods, repro_torch.serve, repro_torch.obs, "
            "repro_torch.checkpoint, repro_torch.runtime, repro_torch.data, "
            "repro_torch.obs.calibrate, repro_torch.obs.history, "
            "repro_torch.obs.regress, repro_torch.obs.report, "
            "repro_torch.launch, repro_torch.launch.mesh, "
            "repro_torch.core.distributed; "
            f"bad = sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r}); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path}: imports {name}"
