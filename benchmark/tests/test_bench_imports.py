"""Nothing the benchmark loads is JAX, flax or the JAX package
(``shiftnet_tpu``), compared by whole top-level names; the reference
imports nothing of the program."""
import subprocess
import sys
from pathlib import Path

from benchmark import harness, manifest

ROOT = manifest.ROOT


def test_run_loads_no_jax_nor_the_jax_package():
    code = ('import sys, benchmark.run, benchmark.restore, benchmark.train, '
            'benchmark.control, shiftnet_tpu_torch.eval.runner, '
            'shiftnet_tpu_torch.train.step, shiftnet_tpu_torch.train.optim;'
            'from benchmark.harness import forbidden_modules;'
            'print(forbidden_modules());'
            'print(int("shiftnet_tpu_torch" in sys.modules))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split('\n')
    assert out[0] == '[]'
    assert out[1] == '1'


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'shiftnet_tpu_torch_extra', sys)
    assert 'shiftnet_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'shiftnet_tpu.ops', sys)
    assert harness.forbidden_modules() == ['shiftnet_tpu']


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / 'benchmark' / 'reference').glob('*.py'):
        text = path.read_text()
        assert 'shiftnet_tpu' not in text, path
        assert 'jax' not in text, path
    for path in Path(ROOT / 'benchmark').rglob('*.py'):
        if 'tests' in path.parts:
            continue
        assert 'import jax' not in path.read_text(), path
