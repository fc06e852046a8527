"""No JAX in the measured process, compared by whole top-level names, and a
reference that imports nothing of the program."""

import os
import subprocess
import sys
import types

from portbench import run

REPO = os.path.dirname(run.HERE)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("rkmh_tpu_torch", "rkmh_tpu_torch.ops", "jaxtyping", "jax_extra.x",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    for name in ("rkmh_tpu.ops", "jaxlib", "flax.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["flax.core", "jaxlib", "rkmh_tpu.ops"]


def test_reference_imports_nothing_of_the_program():
    script = ("import sys, portbench.reference.stream, portbench.reference.hpv16, "
              "portbench.reference.call, portbench.control, portbench.work; "
              "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'rkmh_tpu_torch', 'rkmh_tpu', 'jax', 'jaxlib', 'flax'}))")
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_reference_sources_name_no_program_module():
    ref = os.path.join(run.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            src = open(os.path.join(ref, f)).read()
            assert "rkmh_tpu" not in src and "import jax" not in src, f


def test_a_cpu_run_loads_no_jax(tmp_path):
    script = ("import os, sys; from portbench import run; "
              "from portbench.tests.conftest import tiny; "
              "run.CACHE = sys.argv[1]; cfg, tr = tiny('stream'); "
              "out = run.run_cell(cfg, tr, 3, 0.0, False, [], 'cpu', 0.0); "
              "print(out['correct'], run.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, RKMH_TPU_PANEL_CACHE="0"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"
