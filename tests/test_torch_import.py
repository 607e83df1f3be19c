"""PyTorch port: the package and every submodule import with JAX made
unimportable, and no source file of the port names it."""

import os
import pathlib
import pkgutil
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "reprover_tpu_torch")


def _modules():
    import reprover_tpu_torch

    names = ["reprover_tpu_torch"]
    for info in pkgutil.walk_packages(reprover_tpu_torch.__path__, "reprover_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    names = _modules()
    assert "reprover_tpu_torch.prover.evaluate" in names
    assert "reprover_tpu_torch.ops.flash_attention" in names
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_jax_import_in_port_sources():
    offenders = []
    for path in [os.path.join(REPO_ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")
    ]:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import jax", "from jax")):
                    offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders


def test_port_api_fully_annotated(monkeypatch):
    """The port keeps the JAX package's typing gate (tests/test_annotations.py)."""
    import test_annotations

    monkeypatch.setattr(test_annotations, "PACKAGE", pathlib.Path(PORT))
    missing = test_annotations._missing_annotations()
    assert not missing, missing
