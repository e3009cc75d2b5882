"""The port stands alone: `repro_torch` and `chip_smoke.py` import with JAX
made unimportable and import nothing of `repro`, and `chip_smoke.py` fails
(prints no result) without a CUDA device or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _port_modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for name in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert not [m for m in sys.modules if m == 'repro' or "
        "m.startswith(('repro.', 'jax.'))], 'repro or jax got imported'\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_repro_or_jax():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), (path, name)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    runs = [subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                               env=env, capture_output=True, text=True,
                               timeout=300))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
