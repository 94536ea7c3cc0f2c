"""The port's tests keep one CPU-thread policy, ``tests/_torch_cpu.py``:
every ``tests/test_torch_*.py`` imports its module-scoped fixture, and no
test module but the helper sets torch's thread count."""

import ast
from pathlib import Path

from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

TESTS = Path(__file__).resolve().parent
HELPER = "_torch_cpu.py"


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _imports_fixture(tree: ast.Module) -> bool:
    return any(isinstance(node, ast.ImportFrom) and node.module == HELPER[:-3]
               and any(alias.name == "one_thread" and alias.asname is None for alias in node.names)
               for node in tree.body)


def _sets_threads(tree: ast.Module) -> list[int]:
    return [node.lineno for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) == "set_num_threads"]


def test_every_port_module_imports_the_thread_fixture():
    modules = sorted(TESTS.glob("test_torch_*.py"))
    assert len(modules) > 30
    assert [p.name for p in modules if not _imports_fixture(_tree(p))] == []


def test_only_the_helper_sets_the_thread_count():
    assert _sets_threads(_tree(TESTS / HELPER))
    assert {p.name: lines for p in sorted(TESTS.glob("*.py")) if p.name != HELPER
            for lines in [_sets_threads(_tree(p))] if lines} == {}
