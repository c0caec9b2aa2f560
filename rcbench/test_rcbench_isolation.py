"""The benchmark runs the port alone: no module under `rcbench/` imports
JAX or the JAX package (`repro`, compared as a whole top-level name, so
`repro_torch` passes), the reference imports nothing of the port, and
nothing here reads the JAX package's benchmark or its results."""
import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return sorted(HERE.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(HERE)): _imports(p) & JAX for p in _sources()}
    assert not {k: v for k, v in bad.items() if v}
    assert "repro_torch" in _imports(HERE / "serve.py")       # the port itself passes


def test_the_reference_imports_nothing_of_the_port():
    for p in (HERE / "reference").glob("*.py"):
        assert not _imports(p) & (JAX | {"repro_torch"}), p


def test_nothing_reads_the_jax_packages_benchmark():
    needles = ("bench" + "marks/", "results/" + "bench", "bench" + "marks.")
    for p in _sources():
        if p.name.startswith("test_"):
            continue
        text = p.read_text()
        assert not any(n in text for n in needles), p


def test_importing_the_harness_loads_no_jax():
    root = HERE.parent
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import rcbench.run, rcbench.serve, rcbench.correct, rcbench.trace\n"
            "import rcbench.reference.dense_gqa, rcbench.counts.window\n"
            "from rcbench.metrics import reader\n"
            "import json; b = json.load(open('BENCHMARK.json'))\n"
            "[reader(m['name']) for g in ('end_to_end', 'per_layer') for m in b[g]]\n"
            "import repro_torch.serving.server, repro_torch.core.rcllm\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
