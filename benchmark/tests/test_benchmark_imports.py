"""Nothing the benchmark or its reference loads is JAX or the JAX package
(top-level names compared whole: the port's own name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import subprocess
import sys

from benchmark import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "openglraytracer_tpu")
PROGRAM = "openglraytracer_tpu_torch"


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import tiny\n"
        "from benchmark import harness\n"
        "for w in ('c3_grid64.render', 'c3_grid64.train'):\n"
        "    for tr in (False, True):\n"
        "        harness.run_cell(tiny(w), 5, 0.2, tr, 'cpu',\n"
        "                         time.monotonic())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    tops = eval(_run(code).strip().splitlines()[-1])
    assert PROGRAM in tops          # the program did run
    assert not set(tops) & set(FORBIDDEN), set(tops) & set(FORBIDDEN)


def test_check_modules_compares_whole_names():
    assert "openglraytracer_tpu_torch" not in harness.FORBIDDEN
    assert all(m.split(".")[0] != "openglraytracer_tpu"
               for m in harness.check_modules())


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.tracer\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    tops = eval(_run(code).strip().splitlines()[-1])
    assert not set(tops) & set(FORBIDDEN + (PROGRAM,))
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "math", "__future__",
                                           "benchmark"), (path, n)
                assert not n.startswith("benchmark.") or \
                    n.startswith("benchmark.reference"), (path, n)
