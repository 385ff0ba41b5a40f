"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the program: module names compared whole by
their top-level part (``nerfmlp_torch`` is not ``nerfmlp_tpu``). Nothing in
the benchmark reads the JAX package's old benchmark files."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

HERE = harness.HERE
BANNED = {"jax", "jaxlib", "flax", "nerfmlp_tpu"}


def sources(sub: str = ""):
    top = os.path.join(HERE, sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs
            if f.endswith(".py")]


def imported(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('MODULES', *sorted({m.split('.')[0] for m "
                          "in sys.modules}))"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES")]
    return set(line[-1].split()[1:])


def test_whole_names_are_compared():
    assert "nerfmlp_torch".split(".")[0] not in BANNED
    assert harness.banned_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & BANNED)


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(
    p, HERE))
def test_no_module_of_the_benchmark_imports_jax(path):
    assert not set(imported(path)) & BANNED


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "nerfmlp_torch" not in set(imported(path))


def test_a_dry_import_loads_no_jax():
    mods = loaded_after("import benchmark.run, benchmark.calibrate, "
                        "benchmark.drivers.train, benchmark.drivers.frames")
    assert not mods & BANNED


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_after("import benchmark.reference.nerf, "
                        "benchmark.reference.data, benchmark.reference.fp8, "
                        "benchmark.reference.png, benchmark.check")
    assert "nerfmlp_torch" not in mods and not mods & BANNED


def test_a_whole_run_loads_no_jax():
    mods = loaded_after("from benchmark.tests._tiny import tiny_run\n"
                        "assert tiny_run('turbo_train')['correct']")
    assert "nerfmlp_torch" in mods and not mods & BANNED


def test_nothing_reads_the_old_benchmark_files():
    names = ("bench.py", "bench_full.json", "BENCH_r")
    for path in sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        text = open(path).read()
        assert not any(n in text for n in names), path
