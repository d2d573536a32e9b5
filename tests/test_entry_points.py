"""Entry points that must hold on any machine: the main path imports only
JAX, numpy and scipy, and chip_smoke.py refuses to report a result without a
GPU or outside a checkout."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWED = {"jax", "jaxlib", "numpy", "scipy"}
FIRST_PARTY = {"mogasr", "cli", "bench", "chip_smoke"}

# What `import jax` (with the Pallas GPU route), numpy and scipy load by
# themselves; anything an entry point adds beyond that must be stdlib,
# first-party or one of ALLOWED.
_PROBE = """
import importlib, json, sys
import jax, jax.numpy, jax.experimental.pallas, jax.experimental.pallas.triton
import numpy, scipy
base = {n.split(".")[0] for n in sys.modules}
importlib.import_module(sys.argv[1])
new = {n.split(".")[0] for n in sys.modules} - base - set(sys.stdlib_module_names)
print(json.dumps(sorted(n for n in new if not n.startswith("_"))))
"""


def _run(args, cwd, **env):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu", **env})


@pytest.mark.parametrize("module", [
    "mogasr.pipeline", "mogasr.am.gmm_pallas", "mogasr.serving.engine",
    "cli.eval", "cli.decode", "cli.serve", "cli.train_gmm", "bench",
    "chip_smoke",
])
def test_main_path_imports_only_jax_numpy_scipy(module):
    out = _run(["-c", _PROBE, module], ROOT, PYTHONPATH=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    extra = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert extra <= ALLOWED | FIRST_PARTY, extra - ALLOWED - FIRST_PARTY
    assert not extra & {"flax", "orbax", "optax", "tensorstore"}


def _no_result_line(stdout):
    return not any('"ok": true' in line for line in stdout.splitlines())


def test_chip_smoke_fails_without_gpu():
    out = _run(["chip_smoke.py"], ROOT)
    assert out.returncode != 0
    assert _no_result_line(out.stdout)
    assert "needs a GPU" in out.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path), PYTHONPATH="")
    assert out.returncode != 0
    assert _no_result_line(out.stdout)


def test_bench_refuses_cpu():
    out = _run(["bench.py"], ROOT)
    assert out.returncode != 0
    assert _no_result_line(out.stdout) and "measures a GPU" in out.stderr
