"""Run one of the JAX package's examples against the PyTorch port.

    python3 scripts/run_example.py NAME [--device cpu]
                                   [--set N_ITER=300 --set N_TUNE=100 ...]

NAME is a file of ``examples/`` without ``.py`` (``got``,
``parallel_tempering``, ...).  The example runs from its unedited source:
a copy under ``build/examples/`` with every ``dynetlsm_tpu`` import
swapped for ``dynetlsm_tpu_torch`` (:func:`port_source`), imported as a
module (:func:`load_port_example`); an example that guards its work behind
``__main__`` runs as its own main.  The estimators run on the card by
default; ``--device cpu`` gives them ``device='cpu'`` for this run only.
``--set NAME=VALUE`` replaces the value of a module constant (the budget
constants ``N_ITER, N_TUNE, N_BURN = ...`` and the like) in the copy.

The examples need what they import: numpy and the port for ``got``,
``military_alliances`` and ``parallel_tempering``; scikit-learn and
pandas for the simulation studies; matplotlib and networkx for the
plotting ones.
"""
import argparse
import importlib.util
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, 'examples')
OUT = os.path.join(ROOT, 'build', 'examples')

_SWAP = re.compile(r'\bdynetlsm_tpu\b(?!_torch)')
_CONSTANTS = re.compile(r'^([A-Z][A-Z0-9_]*(?:, [A-Z][A-Z0-9_]*)*) = (.+)$',
                        re.M)


def port_source(name, constants=None):
    """The source of ``examples/NAME.py`` with ``dynetlsm_tpu`` swapped for
    ``dynetlsm_tpu_torch``, and the module constants named in
    ``constants`` (a dict of name to Python literal text) set there: a
    line ``A, B = x, y`` becomes ``A, B = <A's>, y`` for A given."""
    with open(os.path.join(EXAMPLES, name + '.py')) as f:
        src = _SWAP.sub('dynetlsm_tpu_torch', f.read())
    constants = dict(constants or {})

    def replace(m):
        names = m.group(1).split(', ')
        if not any(k in constants for k in names):
            return m.group(0)
        values = ([m.group(2)] if len(names) == 1 else
                  [v.strip() for v in m.group(2).split(',')])
        if len(values) != len(names):
            raise ValueError('cannot split %r into %d values'
                             % (m.group(0), len(names)))
        return '%s = %s' % (m.group(1), ', '.join(
            str(constants.pop(k, v)) for k, v in zip(names, values)))

    src = _CONSTANTS.sub(replace, src)
    if constants:
        raise ValueError('examples/%s.py sets no constant %s'
                         % (name, sorted(constants)))
    return src


def load_port_example(name, constants=None, out_dir=OUT, main=False):
    """Write :func:`port_source` to ``out_dir`` and import it (as
    ``__main__`` when ``main``, so a guarded example runs its work).
    Returns the module."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + '.py')
    with open(path, 'w') as f:
        f.write(port_source(name, constants))
    spec = importlib.util.spec_from_file_location(
        '__main__' if main else 'port_example_' + name, path)
    module = importlib.util.module_from_spec(spec)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec.loader.exec_module(module)
    return module


def estimators_on(device):
    """The port's three estimators with ``device`` as their default: for
    ``dynetlsm_tpu_torch``'s names while an example runs (``--device``)."""
    import dynetlsm_tpu_torch as port

    def on(cls):
        def __init__(self, *args, **kw):
            kw.setdefault('device', device)
            cls.__init__(self, *args, **kw)
        return type(cls.__name__, (cls,), {'__init__': __init__,
                                           '__module__': cls.__module__})
    return {name: on(getattr(port, name)) for name in port.__all__}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('name')
    parser.add_argument('--device', default=None,
                        help="the estimators' device (default: theirs, "
                             "the card)")
    parser.add_argument('--set', action='append', default=[],
                        metavar='NAME=VALUE')
    args = parser.parse_args(argv)
    constants = dict(kv.split('=', 1) for kv in args.set)
    if args.device is not None:
        sys.path.insert(0, ROOT)
        import dynetlsm_tpu_torch as port
        for name, cls in estimators_on(args.device).items():
            setattr(port, name, cls)
    load_port_example(args.name, constants, main=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
