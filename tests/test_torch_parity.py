"""Every public name of ``repro`` has its counterpart in ``repro_torch``.

Both packages are read as text through ``ast``; neither is imported.  A
public name is one that does not start with ``_``: a module's top-level
functions and classes, a class's methods (``__init__`` too) and fields
(dataclass and NamedTuple annotations), every parameter of those functions
and methods, and the entries of a module's ``__all__``.  Each name of a
``repro`` module must be in the same module of ``repro_torch``; a port may
add names and parameters (``device``), never drop one.  A kernel's plain
versions, which ``repro`` keeps in ``ref.py``, live beside the wrapper in the
port's ``ops.py`` (``MOVED``).  The only exceptions are ``EXCEPTIONS``, each
with the port's counterpart and the reason (an excepted function or class
covers its parameters, methods and fields); the table is closed: an entry
whose name no longer exists in ``repro``, or that now exists in the port,
fails.  So a name added to ``repro`` fails here until the port has it.
"""

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_KERNELS = ("gated_expert", "mmse_interp", "switch_select", "tree_infer")

#: ``repro`` modules whose names the port keeps in another module
MOVED = {f"kernels/{k}/ref.py": f"kernels/{k}/ops.py" for k in _KERNELS}

_PALLAS = "a Pallas TPU entry: the port's kernel is csrc/{}.cu, behind the wrapper"
_INTERPRET = "Pallas interpret mode: the port's wrappers take the plain version on a CPU tensor"
_MESH = ("a jax.sharding mesh: the port shards over a torch.distributed group "
         "(core/topology.py CellTopology, spawn_ranks)")

#: (``repro`` module, name) -> (the port's counterpart, why the name is not there)
EXCEPTIONS: dict[tuple[str, str], tuple[str, str]] = {
    # the Pallas kernels themselves
    ("kernels/mmse_interp/mmse_interp.py", "mmse_interp_2d"):
        ("csrc/mmse_interp.cu", _PALLAS.format("mmse_interp")),
    ("kernels/mmse_interp/__init__.py", "__all__:mmse_interp_2d"):
        ("csrc/mmse_interp.cu", _PALLAS.format("mmse_interp")),
    ("kernels/switch_select/switch_select.py", "switch_select_2d"):
        ("csrc/switch_select.cu", _PALLAS.format("switch_select")),
    ("kernels/switch_select/switch_select.py", "switch_select_batched_2d"):
        ("csrc/switch_select.cu", _PALLAS.format("switch_select")),
    ("kernels/switch_select/switch_select.py", "switch_gather_batched_2d"):
        ("csrc/switch_select.cu", _PALLAS.format("switch_select")),
    ("kernels/switch_select/__init__.py", "__all__:switch_select_2d"):
        ("csrc/switch_select.cu", _PALLAS.format("switch_select")),
    ("kernels/switch_select/__init__.py", "__all__:switch_gather_batched_2d"):
        ("csrc/switch_select.cu", _PALLAS.format("switch_select")),
    ("kernels/tree_infer/tree_infer.py", "tree_infer_2d"):
        ("csrc/tree_infer.cu", _PALLAS.format("tree_infer")),
    ("kernels/tree_infer/__init__.py", "__all__:tree_infer_2d"):
        ("csrc/tree_infer.cu", _PALLAS.format("tree_infer")),
    ("kernels/gated_expert/gated_expert.py", "gated_expert_fused"):
        ("csrc/gated_expert.cu", _PALLAS.format("gated_expert")),
    ("kernels/gated_expert/__init__.py", "__all__:gated_expert_fused"):
        ("csrc/gated_expert.cu", _PALLAS.format("gated_expert")),
    # interpret mode
    ("kernels/mmse_interp/ops.py", "mmse_interp(interpret)"): ("the device", _INTERPRET),
    ("kernels/switch_select/ops.py", "switch_select(interpret)"): ("the device", _INTERPRET),
    ("kernels/switch_select/ops.py", "switch_select_leaf(interpret)"):
        ("the device", _INTERPRET),
    ("kernels/switch_select/ops.py", "switch_select_batched_leaf(interpret)"):
        ("the device", _INTERPRET),
    ("kernels/switch_select/ops.py", "switch_gather_batched_leaf(interpret)"):
        ("the device", _INTERPRET),
    ("kernels/tree_infer/ops.py", "tree_infer(interpret)"): ("the device", _INTERPRET),
    ("kernels/gated_expert/ops.py", "gated_expert_apply(interpret)"):
        ("the device", _INTERPRET),
    # the tree kernel's MXU operands
    **{("kernels/tree_infer/ops.py", name): (
        "tree_infer(x, feature, threshold, leaf_values, depth)",
        "the MXU's dense one-hot operands: the port's kernel walks the level-order "
        "tables") for name in (
            "PackedTree", "PackedTree.t", "PackedTree.thr", "PackedTree.a", "PackedTree.b",
            "PackedTree.n_on", "PackedTree.leaf_vals", "PackedTree.n_features",
            "PackedTree.depth", "pack_tree", "tree_infer(tree)")},
    **{("kernels/tree_infer/__init__.py", f"__all__:{name}"): (
        "tree_infer(x, feature, threshold, leaf_values, depth)",
        "the MXU's dense one-hot operands: the port's kernel walks the level-order "
        "tables") for name in ("PackedTree", "pack_tree")},
    ("core/closed_loop.py", "DeviceTreePolicy.packed"): (
        "DeviceTreePolicy.feature / threshold / leaf_modes",
        "the packed MXU operands: the port's kernel walks the level-order tables"),
    # the mesh
    ("core/topology.py", "make_ue_mesh"): ("make_ue_shards, spawn_ranks", _MESH),
    ("core/topology.py", "open_loop_fn"): ("run_sharded", _MESH),
    ("core/topology.py", "closed_loop_fn"): ("run_closed_loop_sharded", _MESH),
    ("core/topology.py", "streaming_open_loop_fn"):
        ("core/streaming.py over a CellTopology", _MESH),
    ("core/topology.py", "streaming_closed_loop_fn"):
        ("core/streaming.py over a CellTopology", _MESH),
    ("core/topology.py", "CellTopology.mesh"): ("the process group", _MESH),
    ("core/topology.py", "CellTopology.build(mesh)"): ("the process group", _MESH),
    ("phy/channel.py", "apply_cell_coupling(axis_name)"):
        ("apply_cell_coupling(reduce)", _MESH),
    ("distributed/sharding.py", "named_sharding"): (
        "distributed.sharding.distribute",
        "a jax.sharding.NamedSharding: the port places DTensors on a DeviceMesh"),
    ("distributed/__init__.py", "__all__:named_sharding"): (
        "distributed.sharding.distribute",
        "a jax.sharding.NamedSharding: the port places DTensors on a DeviceMesh"),
    ("launch/dryrun.py", "lower_cell"): (
        "launch/dryrun.py plan_cell, distributed/accounting.py",
        "XLA's lowering: the port runs the step on a fake group and counts it"),
    ("launch/dryrun.py", "collective_bytes"): (
        "distributed/accounting.py StepAccount",
        "bytes read from XLA's HLO: the port counts each collective as it is issued"),
    # other arguments
    ("kernels/gated_expert/ops.py", "gated_expert_apply(folded)"): (
        "gated_expert_apply(ai)",
        "the folded GEMM weights: the port's kernel takes the estimator's module"),
    ("kernels/gated_expert/ref.py", "gated_expert_apply_ref(folded)"): (
        "gated_expert_apply_ref(ai)",
        "the folded GEMM weights: the port's plain version runs the estimator's module"),
    ("kernels/switch_select/ref.py", "switch_select_ref(alternatives)"): (
        "switch_select_ref(mode, outputs)",
        "the port's plain version takes the designated-first list, as the wrapper does"),
    ("kernels/switch_select/ref.py", "switch_select_ref(designated)"): (
        "switch_select_ref(mode, outputs)",
        "the port's plain version takes the designated-first list, as the wrapper does"),
    ("kernels/switch_select/ref.py", "switch_select_batched_ref(alternatives)"): (
        "switch_select_batched_ref(modes, outputs)",
        "the port's plain version takes the designated-first list, as the wrapper does"),
    ("kernels/switch_select/ref.py", "switch_select_batched_ref(designated)"): (
        "switch_select_batched_ref(modes, outputs)",
        "the port's plain version takes the designated-first list, as the wrapper does"),
    ("core/telemetry.py", "ring_push(vec)"): (
        "ring_push(vecs)", "the port's ring carries the UE axis: one vector a UE"),
}


def _params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if not n.startswith("_") and n not in ("self", "cls")]


def _function(names: set[str], prefix: str, fn) -> None:
    names.add(prefix + fn.name)
    names.update(f"{prefix}{fn.name}({p})" for p in _params(fn))


def surface(path: Path) -> set[str]:
    """The public names of one module, as the module docstring defines them."""
    names: set[str] = set()
    if not path.exists():
        return names
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                _function(names, "", node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names.add(node.name)
            for item in node.body:
                if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                    if not item.target.id.startswith("_"):
                        names.add(f"{node.name}.{item.target.id}")
                elif isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if not item.name.startswith("_") or item.name == "__init__":
                        _function(names, f"{node.name}.", item)
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                names.update(f"__all__:{e.value}" for e in node.value.elts
                             if isinstance(e, ast.Constant))
    return names


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _port_module(module: str) -> Path:
    return PORT / MOVED.get(module, module)


@pytest.mark.parametrize("module", REF_MODULES)
def test_repro_module_has_its_counterpart(module):
    """Every public name of this ``repro`` module is in the port's module,
    or in ``EXCEPTIONS``; every exception of the module is still needed."""
    ref, port = surface(REF / module), surface(_port_module(module))
    excepted = {name for (mod, name) in EXCEPTIONS if mod == module}
    # an excepted function or class covers its parameters, methods and fields
    missing = sorted(n for n in ref - port - excepted
                     if not any(n.startswith((e + "(", e + ".")) for e in excepted))
    assert not missing, (f"repro/{module}: no counterpart in repro_torch/"
                         f"{MOVED.get(module, module)} for {missing}")
    gone = sorted(excepted - ref)
    assert not gone, f"EXCEPTIONS name {gone}, which repro/{module} no longer has"
    ported = sorted(excepted & port)
    assert not ported, f"EXCEPTIONS name {ported}, which the port now has: drop them"


def test_exceptions_name_reference_modules_with_reasons():
    for (module, name), (counterpart, reason) in EXCEPTIONS.items():
        assert module in REF_MODULES, module
        assert counterpart and len(reason) > 20, (module, name)


def test_surface_reads_names_parameters_fields_and_all(tmp_path):
    """What ``surface`` counts, on a module written for it."""
    src = tmp_path / "m.py"
    src.write_text(
        "__all__ = ['f', 'C']\n"
        "def f(a, *, b=1, _c=2, **kw): ...\n"
        "def _private(x): ...\n"
        "class C:\n"
        "    x: int\n"
        "    _y: int\n"
        "    def __init__(self, z): ...\n"
        "    def m(self, q): ...\n"
        "    def _h(self, r): ...\n")
    assert surface(src) == {
        "__all__:f", "__all__:C", "f", "f(a)", "f(b)", "f(kw)", "C", "C.x",
        "C.__init__", "C.__init__(z)", "C.m", "C.m(q)"}
