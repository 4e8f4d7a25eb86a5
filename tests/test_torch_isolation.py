"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (whose name is
a prefix of ``repro_torch``, so the check compares whole module names),
importing the port loads neither, no metric name outside the documented
inventory appears in it (tools/metriclint.py scans all of ``src/``), and
``chip_smoke.py`` refuses to run without a card and without the rest of
the repository."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files(suffixes=(".py",)):
    files = sorted(p for p in PORT.rglob("*") if p.suffix in suffixes)
    return files + [ROOT / "chip_smoke.py"]


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # importlib.import_module("...") and the like
            if re.fullmatch(r"[A-Za-z_][\w.]*", node.value):
                yield node.lineno, "str:" + node.value


def test_port_imports_neither_jax_nor_repro():
    bad = []
    for path in port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for line, name in imported_names(tree):
            if name.startswith("str:"):
                name = name[4:]
                if "." not in name:     # a plain word, not a module path
                    continue
            if forbidden(name):
                bad.append(f"{path.relative_to(ROOT)}:{line}: {name}")
    assert not bad, bad
    assert not forbidden("repro_torch.models") and forbidden("repro.models")


def test_importing_the_port_loads_neither():
    code = ("import sys, repro_torch.streaming.runtime, "
            "repro_torch.models.convert, repro_torch.kernels.ops, "
            "repro_torch.kernels._build, repro_torch.data.pipeline; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_undocumented_metric_names():
    metric = re.compile(r"\bersap_[a-z0-9_]+")
    documented = set(metric.findall(
        (ROOT / "docs" / "ARCHITECTURE.md").read_text()))
    used = {}
    for path in port_files((".py", ".cu", ".cuh")):
        for name in metric.findall(path.read_text()):
            used.setdefault(name, str(path.relative_to(ROOT)))
    missing = {n: w for n, w in used.items() if n not in documented}
    assert not missing, missing


def _smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""           # no card, even where one is
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = _smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
