"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole: ``r2l_tpu_torch`` is not ``r2l_tpu``), and the
reference loads nothing of the program."""
import ast
import subprocess
import sys

from harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "r2l_tpu"}


def _imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in cells.BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (cells.BENCH_DIR / "reference").glob("*.py"):
        tops = _imports(path)
        assert "r2l_tpu_torch" not in tops and not tops & FORBIDDEN, path


def _modules_after(code: str) -> set[str]:
    prog = (f"import sys; sys.path[:0] = [{str(cells.ROOT)!r}, "
            f"{str(cells.BENCH_DIR)!r}]\n" + code
            + "\nprint(' '.join(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=cells.ROOT)
    return set(out.stdout.split()[-10**6:])


def test_a_run_of_every_kind_loads_no_jax():
    tops = _modules_after(
        "sys.path.insert(0, 'benchmark/tests'); import _tiny\n"
        "from harness import cells\n"
        "for w in cells.load_spec()['workloads']:\n"
        "    assert _tiny.run(w['name'])['result']['correct']")
    assert "r2l_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = _modules_after("import reference.r2l, reference.nerf")
    assert "torch" in tops
    assert "r2l_tpu_torch" not in tops and not tops & FORBIDDEN
