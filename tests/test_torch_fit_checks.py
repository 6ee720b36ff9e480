"""``scripts/fit_checks.py`` at its ``--quick`` size on the CPU: every
reading of the north-star AUC part and one seed of the one-chain directed
LSM part, one JSON line each."""
import importlib.util
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        'fit_checks', os.path.join(ROOT, 'scripts', 'fit_checks.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quick_readings_on_the_cpu(monkeypatch, tmp_path):
    out = tmp_path / 'fit_checks.jsonl'
    monkeypatch.setattr('sys.argv', [
        'fit_checks.py', '--quick', '--device', 'cpu', '--seeds', '3',
        '--out', str(out)])
    assert _script().main() == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    auc = {r['reading']: r for r in rows if r['part'] == 'auc'}
    assert set(auc) == {'sound fit', 'start', 'random positions',
                        'nodes permuted', 'no nested lsm', 'intercept at 0'}
    assert all(0.0 <= r['auc'] <= 1.0 and r['n'] == 60 for r in auc.values())
    assert auc['intercept at 0']['intercept_mean'] == 0.0
    # scrambled positions rank the dyads no better than chance
    assert abs(auc['random positions']['auc'] - 0.5) < 0.1
    radius = [r for r in rows if r['part'] == 'radius']
    assert [r['seed'] for r in radius] == [3]
    assert np.isfinite(radius[0]['radii_max']) and radius[0]['chains'] == 1
