"""The port stands alone: importing every module of ``repro_torch`` pulls in
neither ``jax`` nor ``repro``, and ``chip_smoke.py`` names neither."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_import_every_module_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_names_jax_or_repro():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f


def test_topology_and_service_modules_are_walked():
    """The multi-cell topology and the campaign service are among the
    modules the probe above imports without JAX."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.core.topology", "repro_torch.service", "repro_torch.service.service",
            "repro_torch.service.api", "repro_torch.service.ring",
            "repro_torch.service.exporters", "repro_torch.service.__main__"} <= names


def test_training_and_lm_serving_modules_are_walked():
    """The optimizer, the LM stack's configs, models, serving and launcher
    are among the modules the probe above imports without JAX."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.models", "repro_torch.models.config", "repro_torch.models.params",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.decode", "repro_torch.models.model",
            "repro_torch.serving", "repro_torch.serving.switched",
            "repro_torch.serving.engine", "repro_torch.launch.serve",
            "repro_torch.configs.granite_20b", "repro_torch.configs.command_r_plus_104b",
            "repro_torch.configs.qwen1_5_110b"} <= names
