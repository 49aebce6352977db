"""What the benchmark runs imports neither JAX nor the JAX package, and
the reference imports nothing of the program (top-level module names
compared whole: ``vk_renderer_tpu_torch`` begins with
``vk_renderer_tpu``)."""

import ast
from pathlib import Path

from vkbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "vk_renderer_tpu"}
BENCH = manifest.BENCH_DIR
ROOT = manifest.ROOT


def _imports(path: Path):
    """(absolute module names, relative (level, module) pairs) of a
    file."""
    tree = ast.parse(path.read_text(), str(path))
    absolute, relative = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            absolute += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative.append((node.level, node.module,
                                 [a.name for a in node.names]))
            else:
                absolute.append(node.module)
    return absolute, relative


def _resolve(path: Path, level: int, module):
    base = path.parent
    for _ in range(level - 1):
        base = base.parent
    target = base.joinpath(*(module or "").split(".")) if module else base
    return target


def _local_files(target: Path):
    if target.with_suffix(".py").is_file():
        return [target.with_suffix(".py")]
    if (target / "__init__.py").is_file():
        return [target / "__init__.py"]
    return []


def _closure(start_files, roots):
    """Every file reachable by imports from ``start_files`` inside the
    package roots ``roots`` (name -> directory), and every top-level name
    imported anywhere on the way."""
    seen, names, todo = set(), set(), list(start_files)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        absolute, relative = _imports(f)
        for mod in absolute:
            top = mod.split(".")[0]
            names.add(top)
            if top in roots:
                parts = mod.split(".")
                todo += _local_files(roots[top].joinpath(*parts[1:])) or \
                    _local_files(roots[top].joinpath(*parts[1:-1]))
        for level, module, members in relative:
            target = _resolve(f, level, module)
            todo += _local_files(target)
            for m in members:
                todo += _local_files(target / m)
    return seen, names


def test_nothing_the_benchmark_runs_imports_jax():
    roots = {"vkbench": BENCH / "vkbench", "reference": BENCH / "reference",
             "vk_renderer_tpu_torch": ROOT / "vk_renderer_tpu_torch"}
    start = [BENCH / "run.py", *sorted((BENCH / "metrics").glob("*.py")),
             *sorted((BENCH / "vkbench").glob("*.py")),
             *sorted((BENCH / "reference").rglob("*.py")),
             BENCH / "tests" / "control.py"]
    files, names = _closure(start, roots)
    assert any("vk_renderer_tpu_torch" in str(f) for f in files)
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    files, names = _closure(sorted((BENCH / "reference").rglob("*.py")),
                            {"reference": BENCH / "reference"})
    assert all(BENCH / "reference" in f.parents for f in files)
    assert not {n for n in names if n.startswith("vk_renderer")}
    assert not names & {"vkbench"}
    assert names <= {"__future__", "numpy", "torch", "struct", "zlib",
                     "json", "os", "base64", "dataclasses", "contextlib",
                     "urllib", "zstandard", "reference", "math"}, names
