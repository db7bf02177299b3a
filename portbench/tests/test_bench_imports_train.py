"""What a training run imports: no JAX, no JAX package."""

import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_a_training_run_imports_no_jax():
    """A whole run of the tiny training cell in a fresh process, traced,
    then sys.modules."""
    code = ("import sys, time, torch; sys.path.insert(0, %r);"
            "from portbench import core, run;"
            "from portbench.tests.tiny_train import tiny_train_cell;"
            "res = run.run(tiny_train_cell(), 7, 0.5, True,"
            " torch.device('cpu'), time.time(), log=lambda m: None);"
            "assert res['correct'], res;"
            "assert 'step_ms.train' in res['metrics'], res;"
            "print('FORBIDDEN', core.forbidden_modules())" % ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
