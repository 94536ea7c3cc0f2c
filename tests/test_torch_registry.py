"""The port's launch registry (``align3d_torch/_kernels.py::KERNELS``) on
the CPU: it names every C entry point of ``csrc/*.cu`` with its C argument
types and every row's device kernel; :func:`~align3d_torch._kernels.launch`
is the one place a launch is counted; and the seven old counter names that
``benchmark/trace.py`` reads still read the registry."""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch import _kernels
from benchmark import trace

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "align3d_torch" / "csrc"
TRACE_NAMES = {("icp_fused", "LAUNCHES"): "K1", ("icp_pallas_v4", "LAUNCHES"): "K8",
               ("icp_pallas_v3", "CENTROIDS_LAUNCHES"): "K9", ("icp_pallas_v3", "PREDICT_LAUNCHES"): "K10",
               ("bilateral", "SPLAT_LAUNCHES"): "K2", ("bilateral", "SLICE_LAUNCHES"): "K3a",
               ("bilateral", "NORMALIZE_SLICE_LAUNCHES"): "K3b"}
#: The modules that launch a kernel of the registry.
LAUNCHERS = ["align3d_torch.ops.icp_fused", "align3d_torch.ops.icp_pallas_v3", "align3d_torch.ops.icp_pallas_v4",
             "align3d_torch.ops.bilateral", "align3d_torch.ops.nn_banded", "align3d_torch.ops.mesh",
             "align3d_torch.ops.pyramid", "align3d_torch.viz.sphere", "align3d_torch.optim.gauss_newton",
             "align3d_torch.tools.roofline"]
C_TYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _default_build(text: str) -> str:
    """``text`` less the lines a build without ``-D`` flags leaves out: the
    ``#if`` / ``#elif`` / ``#else`` blocks on a macro (``NAME`` or ``NAME
    == n``), the macro as the file ``#define``\\ s it, else 0."""
    macros, stack, out = {}, [], []  # stack: (this branch is taken, a branch of the block was)
    for line in text.splitlines():
        m = re.match(r"\s*#\s*(ifndef|ifdef|if|elif|else|endif|define)\b(.*)", line)
        live = all(taken for taken, _ in stack)
        if m is None:
            if live:
                out.append(line)
            continue
        kind, rest = m.group(1), m.group(2).split("//")[0].strip()
        if kind == "define" and live:
            name, _, value = rest.partition(" ")
            macros[name] = value.strip() or "1"
        elif kind in ("ifdef", "ifndef"):
            cond = (rest in macros) == (kind == "ifdef")
            stack.append((cond, cond))
        elif kind in ("if", "elif"):
            name, _, rhs = (part.strip() for part in rest.partition("=="))
            value = int(macros.get(name, "0"))
            cond = value == int(rhs) if rhs else bool(value)
            if kind == "elif":
                cond, done = not stack[-1][1] and cond, stack.pop()[1]
                stack.append((cond, done or cond))
            else:
                stack.append((cond, cond))
        elif kind == "else":
            done = stack.pop()[1]
            stack.append((not done, True))
        elif kind == "endif":
            stack.pop()
    return "\n".join(out)


def _sources() -> str:
    return "\n".join(_default_build(p.read_text()) for p in sorted(CSRC.glob("*.cu")))


def _c_type(param: str):
    """The ctypes type of one C parameter declaration."""
    decl = param.replace("const ", "").strip()
    if "*" in decl:
        base = decl.split("*")[0].strip()
        return ctypes.c_void_p if base == "void" else ctypes.POINTER(C_TYPES[base])
    return C_TYPES[decl.rsplit(" ", 1)[0].strip()]


def test_table_names_every_entry_point_with_its_c_types():
    entries = {name: [_c_type(p) for p in params.split(",")]
               for name, params in re.findall(r'extern "C" int (a3d_\w+)\s*\(([^)]*)\)', _sources())}
    assert len(entries) == 15
    assert entries == _kernels.ENTRIES
    # K7 and K8 share one entry point; P2 has two.
    banded = {"a3d_icp_banded": entries["a3d_icp_banded"]}
    assert _kernels.KERNELS["K7"].entries == _kernels.KERNELS["K8"].entries == banded
    assert list(_kernels.KERNELS["P2"].entries) == ["a3d_gather_lane", "a3d_gather_table"]


def test_each_row_names_a_device_kernel():
    kernel = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\("
    text = _sources()
    names = set(re.findall(kernel, text))
    templates = set(re.findall(r"template\s*<[^>]*>\s*" + kernel, text))
    for kid, row in _kernels.KERNELS.items():
        assert row.device, kid
        for part in row.device:
            name, _, args = part.partition("<")
            assert name in (templates if args else names), (kid, part)


def test_trace_names_read_the_registry(monkeypatch):
    """``benchmark/trace.py`` reads seven old names; each is the registry's
    count of its kernel (0 on the CPU), read-only, and no launching module
    keeps a counter of its own."""
    source = ast.parse((ROOT / "benchmark" / "trace.py").read_text())
    read = {(node.value.id, node.attr) for node in ast.walk(source)
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.attr.endswith("LAUNCHES")}
    assert read == set(TRACE_NAMES)
    ops = {name: importlib.import_module(f"align3d_torch.ops.{name}") for name, _ in TRACE_NAMES}
    assert {attr: getattr(ops[mod], attr) for (mod, attr) in TRACE_NAMES} == dict.fromkeys(
        (attr for _, attr in TRACE_NAMES), 0)
    counts = {kid: 10 + i for i, kid in enumerate(_kernels.KERNELS)}
    monkeypatch.setattr(_kernels, "_counts", counts)
    for (mod, attr), kid in TRACE_NAMES.items():
        assert getattr(ops[mod], attr) == counts[kid], (mod, attr)
    assert trace.launch_counts() == {"K1": counts["K1"], "K8": counts["K8"], "K9": counts["K9"], "K10": counts["K10"],
                                     "K2": counts["K2"], "K3": counts["K3a"] + counts["K3b"]}
    with pytest.raises(AttributeError):
        ops["icp_pallas_v3"].LAUNCHES  # K7's old counter: no reader left
    for name in LAUNCHERS:
        assert [a for a in vars(importlib.import_module(name)) if a.endswith("LAUNCHES")] == [], name


def test_launches_returns_a_copy_and_differences(monkeypatch):
    monkeypatch.setattr(_kernels, "_counts", dict.fromkeys(_kernels.KERNELS, 0))
    got = _kernels.launches()
    assert got == dict.fromkeys(_kernels.KERNELS, 0)
    got["K1"] += 5
    assert _kernels.launches()["K1"] == 0
    _kernels._counts["K8"] += 3
    assert _kernels.launches(got) == {**dict.fromkeys(_kernels.KERNELS, 0), "K1": -5, "K8": 3}


class _Library:
    """A stand-in for a loaded build: each entry point records its call and
    returns ``status``."""

    def __init__(self, status: int = 0):
        self.calls, self.status = [], status

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.status
        return entry


def test_launch_calls_the_entry_checks_and_counts(monkeypatch):
    monkeypatch.setattr(_kernels, "_counts", dict.fromkeys(_kernels.KERNELS, 0))
    library = _Library()
    monkeypatch.setattr(_kernels, "lib", lambda: library)
    _kernels.launch("K1", 1, 2)
    _kernels.launch("K7", 0)
    _kernels.launch("K8", 1)
    _kernels.launch("P2", 3, entry="a3d_gather_table")
    assert library.calls == [("a3d_icp_step", (1, 2)), ("a3d_icp_banded", (0,)), ("a3d_icp_banded", (1,)),
                             ("a3d_gather_table", (3,))]
    other = _Library()
    _kernels.launch("K2", 5, library=other)  # another build (the ablation tool's): called, not counted
    assert other.calls == [("a3d_bilateral_splat", (5,))]
    with pytest.raises(ValueError):
        _kernels.launch("P2", 3)  # two entry points: the call names one
    library.status = 700
    with pytest.raises(RuntimeError, match="a3d_gn_update: CUDA error 700"):
        _kernels.launch("K11")
    assert {k: n for k, n in _kernels.launches().items() if n} == {"K1": 1, "K7": 1, "K8": 1, "P2": 1}
