"""The walkthrough notebooks run end to end against the port on the CPU
(fast budgets), as ``tests/test_notebooks.py`` runs them on the JAX
package: each code cell's ``dynetlsm_tpu`` swapped for
``dynetlsm_tpu_torch`` in a copy, and a first cell that gives the port's
estimators ``device='cpu'`` (``scripts/run_example.py::estimators_on``).
"""
import os
import re

import pytest

nbformat = pytest.importorskip('nbformat')
nbclient = pytest.importorskip('nbclient')
pytest.importorskip('ipykernel')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOKS = [
    'notebooks/synthetic_community_splitting.ipynb',
    'notebooks/sampson_monastery.ipynb',
]
_ON_CPU = (
    "import sys\n"
    "sys.path.insert(0, %r)\n"
    "sys.path.insert(0, %r)\n"
    "from run_example import estimators_on\n"
    "import dynetlsm_tpu_torch\n"
    "for _name, _cls in estimators_on('cpu').items():\n"
    "    setattr(dynetlsm_tpu_torch, _name, _cls)\n"
    % (REPO, os.path.join(REPO, 'scripts')))


@pytest.mark.slow
@pytest.mark.parametrize('rel_path', NOTEBOOKS)
def test_port_notebook_executes(monkeypatch, rel_path):
    nb = nbformat.read(os.path.join(REPO, rel_path), as_version=4)
    for cell in nb.cells:
        if cell.cell_type == 'code':
            cell.source = re.sub(r'\bdynetlsm_tpu\b(?!_torch)',
                                 'dynetlsm_tpu_torch', cell.source)
    nb.cells.insert(0, nbformat.v4.new_code_cell(_ON_CPU))
    monkeypatch.setenv('DYNETLSM_NB_FAST', '1')
    client = nbclient.NotebookClient(
        nb, timeout=600, kernel_name='python3',
        resources={'metadata': {'path': REPO}})
    client.execute()  # raises CellExecutionError on any failing cell
