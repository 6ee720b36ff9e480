"""Every configuration, traffic, workload and metric file of the benchmark
parses, and BENCHMARK.json keeps to the benchmark's contract."""
import importlib
import json
import re

import pytest

from port_bench import core

ROOT = core.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.fixture(scope='module')
def bench():
    with open(ROOT / 'BENCHMARK.json') as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['command'] == ['python3', 'port_bench/run.py']
    assert bench['paths'] == ['port_bench']
    assert 1 <= bench['run_seconds'] <= 51


def test_names_units_and_keys(bench):
    names = set()
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('port_bench/')
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in bench[group]:
            assert NAME.match(entry['name']), entry['name']
            assert entry['name'] not in names
            names.add(entry['name'])
    for m in bench['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    e2e = {m['name'] for m in bench['end_to_end']}
    for m in bench['per_layer']:
        assert m['moves'] in e2e


@pytest.mark.parametrize('workload', [
    w['name'] for w in json.loads(
        (core.ROOT / 'BENCHMARK.json').read_text())['workloads']])
def test_every_cell_parses(workload):
    spec = core.load_spec(workload)
    names = {m['name'] for m in spec['end_to_end']}
    assert 'setup_s' in names and len(names) >= 2
    assert spec['per_layer']
    assert spec['config']['name'] == spec['cell']['config']
    assert spec['traffic']['chains'] >= 1
    assert 'latent_update' in spec['traffic']['program']
    for key in ('K', 'model', 'is_directed', 'table_cap'):
        assert key in spec['config']['program']
    assert importlib.import_module(
        'port_bench.networks.' + spec['config']['network']['generator']).draw
    p = spec['params']
    assert p['chunk'] >= 1 and p['burn_in'] >= 0
    assert set(p['check']['limits']) == {'mh_gap', 'logp_gap', 'mix_pit_z',
                                         'stale'}
    assert p['check']['limits']['stale'] == 0
    assert callable(core.reference(spec).judge_capture)
    assert callable(importlib.import_module(
        'port_bench.sweep_counts.' + p['counts']).count)
    for m in spec['per_layer']:
        reader = importlib.import_module(
            'port_bench.metrics.' + core.quantity(m['name']))
        assert callable(reader.read)
