"""Public-name parity of the port: every module of ``align3d_tpu/`` has a
counterpart at the same path under ``align3d_torch/``, or is named below as
deliberately left unported or still to come (ROADMAP; nothing is to come
since the viz slice); and every public class, method and function of a
ported module has a counterpart of the same name there. Both trees are
parsed with ``ast``; nothing is imported."""

import ast
from pathlib import Path

import pytest
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "align3d_tpu", ROOT / "align3d_torch"

# ROADMAP "Deliberately left unported": the TPU-only solve and the pytree
# hooks. The banded engines (ops/icp_pallas_v3.py, ops/icp_pallas_v4.py and
# their align variants) are ported.
UNPORTED_MODULES = set()
UNPORTED_NAMES = {"optim/gauss_newton.py": {"solve_spd"}}
PYTREE = {"tree_flatten", "tree_unflatten"}

# ROADMAP Queue 1: every module is ported.
TO_COME_MODULES = set()
TO_COME_NAMES = {}

# Counterparts that live in another module of the port.
MOVED = {("icp/image_icp.py", "icp_step"): ("ops/icp_fused.py", "icp_step")}


def public_names(path: Path) -> set:
    """Top-level public classes and functions, and ``Class.method`` for each
    public method and property of a top-level class."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{sub.name}" for sub in node.body
                             if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and not sub.name.startswith("_"))
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def test_every_module_is_ported_or_listed():
    missing = {m for m in JAX_MODULES if not (PORT / m).exists()}
    assert missing == UNPORTED_MODULES | TO_COME_MODULES
    # Nothing listed as to come is ported already (the list shrinks with the port).
    assert not any((PORT / m).exists() for m in TO_COME_MODULES)


@pytest.mark.parametrize("module", [m for m in JAX_MODULES if (PORT / m).exists()])
def test_ported_module_has_every_public_name(module):
    ours = public_names(PORT / module)
    excused = UNPORTED_NAMES.get(module, set()) | TO_COME_NAMES.get(module, set())
    missing = set()
    for name in public_names(JAX / module) - ours:
        if name in excused or name.rsplit(".", 1)[-1] in PYTREE:
            continue
        moved = MOVED.get((module, name))
        if moved and moved[1] in public_names(PORT / moved[0]):
            continue
        missing.add(name)
    assert not missing, f"align3d_torch/{module} lacks {sorted(missing)}"
    # An excused name that the port has after all leaves the list.
    assert not (TO_COME_NAMES.get(module, set()) & ours)
