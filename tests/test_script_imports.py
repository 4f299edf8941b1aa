"""Every name the benchmark and top-level scripts import from the package
exists. Most scripts import inside their functions, so importing the module
alone would not catch a name the package has dropped."""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = sorted(
    str(p.relative_to(ROOT))
    for p in [*ROOT.glob("benchmarks/*.py"), ROOT / "bench.py",
              ROOT / "chip_smoke.py", ROOT / "__graft_entry__.py"]
    if p.exists())


def _package_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.level == 0
                and node.module.split(".")[0] == "gpuraytracer_tpu"):
            for alias in node.names:
                yield node.module, alias.name
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "gpuraytracer_tpu":
                    yield alias.name, None


@pytest.mark.parametrize("path", SCRIPTS)
def test_script_package_imports_resolve(path):
    pairs = list(_package_imports(path))
    for module, name in pairs:
        mod = importlib.import_module(module)
        if name is None or hasattr(mod, name):
            continue
        # ``from pkg import submodule``
        importlib.import_module(f"{module}.{name}")
