"""The port stands alone: importing every module of ``repro_torch`` or any
script of ``examples_torch/`` pulls in neither ``jax`` nor ``repro``, and
neither they nor ``chip_smoke.py`` name either."""

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
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             *sorted((ROOT / "examples_torch").glob("*.py"))]
    assert len(files) > 60
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


def test_moe_ssm_and_hybrid_modules_are_walked():
    """The MoE FFN, the Mamba2 mixer and the configs of the MoE, SSM, hybrid
    and VLM families are among the modules the probe imports without JAX."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.models.moe", "repro_torch.models.mamba2",
            "repro_torch.configs.dbrx_132b", "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.configs.mamba2_130m", "repro_torch.configs.zamba2_7b",
            "repro_torch.configs.qwen2_vl_72b"} <= names


def test_training_half_modules_are_walked():
    """The token stream, the gradient compression, the train step and loop,
    and the training launcher are among the modules the probe imports."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.data", "repro_torch.data.tokens", "repro_torch.distributed",
            "repro_torch.distributed.compression", "repro_torch.train",
            "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.launch.train"} <= names


def test_families_and_sharded_training_modules_are_walked():
    """The encoder-decoder and local/global configs and the sharded training
    half (the sharding rules, the mesh shim, the planner's specs and the
    dry-run) are among the modules the probe imports without JAX."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.configs.whisper_large_v3", "repro_torch.configs.gemma2_9b",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.dryrun"} <= names


_EXAMPLES_PROBE = """
import runpy, sys
from pathlib import Path
scripts = sorted(Path("examples_torch").glob("*.py"))
for path in scripts:
    runpy.run_path(str(path), run_name="probe")  # imports and definitions, no main()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(scripts), bad)
assert not bad, bad
"""


def test_examples_import_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _EXAMPLES_PROBE], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) == 4
