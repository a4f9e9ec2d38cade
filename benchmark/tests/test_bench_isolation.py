"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``se195_raytracer_tpu_torch`` begins with the JAX
package's name and is neither."""

import ast
import subprocess
import sys

from harness.manifest import BENCH_DIR
from harness.runner import FORBIDDEN, forbidden_modules

PORT = "se195_raytracer_tpu_torch"


def imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def sources(folder):
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(BENCH_DIR)): sorted(imported_tops(p) & set(FORBIDDEN))
           for p in sources(BENCH_DIR)}
    assert not {k: v for k, v in bad.items() if v}
    assert sources(BENCH_DIR)


def test_the_reference_imports_nothing_of_the_program():
    ref = BENCH_DIR / "reference"
    bad = {p.name: sorted(imported_tops(p) & {PORT, *FORBIDDEN}) for p in sources(ref)}
    assert not {k: v for k, v in bad.items() if v}
    allowed = {"__future__", "typing", "math", "numpy", "torch", "reference"}
    assert set().union(*(imported_tops(p) for p in sources(ref))) <= allowed


def test_top_level_names_are_compared_whole():
    code = ("import sys; sys.path[:0] = [%r, %r]; import se195_raytracer_tpu_torch.driver.render; "
            "import reference.smallpt, reference.inverse, reference.work; "
            "from harness.runner import forbidden_modules; print(forbidden_modules())"
            % (str(BENCH_DIR), str(BENCH_DIR.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
    sys.modules.setdefault("jaxlib_fake_ok", sys)  # a name that only begins with "jax"
    try:
        assert "jaxlib_fake_ok".split(".")[0] not in forbidden_modules()
    finally:
        del sys.modules["jaxlib_fake_ok"]
