"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and
importing the port does not load ``jax``.  The card check refuses to run
without a CUDA device or outside a checkout, and prints no result then.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_every_kind_of_import(tmp_path):
    f = tmp_path / "planted.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import prng\n"
                 "import numpy, repro_torch\nfrom . import x\n"
                 "def g():\n    import jaxlib\n")
    found = list(_imported_modules(f))
    assert found == ["jax.numpy", "repro.core", "numpy", "repro_torch", "jaxlib"]
    assert [_forbidden(m) for m in found] == [True, True, False, False, True]


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_importing_the_port_does_not_load_jax():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.stats, "
            "repro_torch.kernels.build, repro_torch.kernels.hist.ops, "
            "repro_torch.kernels.sampler.ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\nprint('clean')")
    r = _run(["-c", code], ROOT, {"PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run as it is in the checkout (this host has no CUDA device), and
    alone in an empty directory: a non-zero exit and no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        r = _run([str(script)], cwd)
        assert r.returncode != 0, (script, r.stdout)
        assert '"ok"' not in r.stdout, (script, r.stdout)
