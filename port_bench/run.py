"""Run one cell of the benchmark of dynetlsm_tpu_torch on one NVIDIA GPU.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The run builds the cell's network, state
and sweep from the seed, burns in, measures for ``--seconds`` seconds and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` the
``breakdown``, and last ``check``, each compared number beside its limit
(also the last lines of standard error).  It exits non-zero, with no
result, without a CUDA device, when the program cannot be imported, or
when the run loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # a library that would load JAX on its own stays away from it
    os.environ.setdefault('USE_FLAX', '0')
    import torch
    from port_bench.core import load_spec, run
    spec = load_spec(args.workload, ROOT)
    chips = spec['cell']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('port_bench: the cell needs %d CUDA device(s), found %d'
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = run(spec, args.seed, args.seconds, bool(args.trace),
                        torch.device('cuda', 0), T_START)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
