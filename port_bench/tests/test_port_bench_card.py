"""On the card: a short run of each cell is correct.  Run on the chip with
``python3 -m pytest -m cuda port_bench/tests``; ``port_bench/readings.py``
reads the program's and the control's numbers at each cell's size."""
import json
import subprocess
import sys

import pytest

from port_bench import core

CELLS = [w['name'] for w in json.loads(
    (core.ROOT / 'BENCHMARK.json').read_text())['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_short_run_is_correct(cuda_device, workload):
    p = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', workload,
         '--seed', '2147483659', '--seconds', '3', '--trace', '0'],
        cwd=core.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result['correct'], result['check']
