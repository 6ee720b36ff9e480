"""The run command: it fails without a card and without the program, and
nothing it loads is JAX or the JAX package, by whole top-level names."""
import json
import os
import shutil
import subprocess
import sys

from port_bench import core

ROOT = core.ROOT
RUN = ['port_bench/run.py', '--workload', 'hdp_ns_exact', '--seed',
       '4294967311', '--seconds', '1', '--trace', '0']


def _no_result(out):
    for line in out.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable] + RUN, cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert _no_result(p.stdout)


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'port_bench', tmp_path / 'port_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = subprocess.run([sys.executable] + RUN, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert _no_result(p.stdout)


_PROBE = '''
import sys, time
sys.path.insert(0, %r)
import torch
torch.set_num_threads(1)
from port_bench import core, readings, run
from port_bench.tests.helpers import tiny_spec
spec = tiny_spec(n=24)
core.measure(spec, 3, 0.05, True, torch.device('cpu'), time.perf_counter())
print(','.join(core.forbidden_modules()) or 'none')
sys.modules['dynetlsm_tpu_torch_extra'] = sys.modules['port_bench']
sys.modules['jaxlibrary'] = sys.modules['port_bench']
print(','.join(core.forbidden_modules()) or 'none')
sys.modules['dynetlsm_tpu.models'] = sys.modules['port_bench']
print(','.join(core.forbidden_modules()) or 'none')
'''


def test_nothing_loaded_is_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, '-c', _PROBE % str(ROOT)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ['none', 'none', 'dynetlsm_tpu']
