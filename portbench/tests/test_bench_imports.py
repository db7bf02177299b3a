"""What a run may import: no JAX, no JAX package; the reference nothing of
the program."""

import ast
import glob
import os
import subprocess
import sys

from portbench import core

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_are_compared_whole():
    mods = dict(sys.modules)
    try:
        sys.modules["eventclip_tpu_torch_fake"] = sys
        assert "eventclip_tpu" not in core.forbidden_modules()
        sys.modules["eventclip_tpu.fake"] = sys
        assert core.forbidden_modules() == ["eventclip_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_a_run_imports_no_jax():
    """A whole run of the tiny cell in a fresh process, then sys.modules."""
    code = ("import sys, time, torch; sys.path.insert(0, %r);"
            "from portbench import core, run;"
            "from portbench.tests.tiny import tiny_cell;"
            "res = run.run(tiny_cell(), 7, 0.5, True, torch.device('cpu'),"
            " time.time(), log=lambda m: None);"
            "assert res['correct'], res;"
            "print('FORBIDDEN', core.forbidden_modules())" % ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_harness_file_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not imported_tops(path) & set(core.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    for path in files:
        tops = imported_tops(path)
        assert "eventclip_tpu_torch" not in tops, path
        assert not tops & set(core.FORBIDDEN), path
        assert not tops & {"portbench"}, path  # only its own siblings
