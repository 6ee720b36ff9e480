"""The readings each limit of the check is set from: the program's
numbers, the control's (the reference in TF32 in the program's place) and,
with ``--faults``, each fault's that the cell's reference module can plant
in the program's place (its ``FAULTS``), on the same runs, at a cell's own
size, one seed after another in one process.

    python3 port_bench/readings.py --workload <name> --seeds 1,2,3 \\
        --seconds 20 [--control 0] [--faults 1] \\
        [--out chiprun_out/readings.jsonl]

Each seed runs the cell's set-up, burn-in and a window at its own load,
then prints one JSON line with the numbers (``reference/<name>.py``) and
each mixture block's score.  The benchmark's own runs never run the
control or the faults.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--control', type=int, choices=(0, 1), default=1)
    parser.add_argument('--faults', type=int, choices=(0, 1), default=0)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from port_bench.core import check_run, load_spec, measure, reference
    if not torch.cuda.is_available():
        print('readings: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    spec = load_spec(args.workload, ROOT)
    out = open(args.out, 'a') if args.out else None
    for seed in [int(s) for s in args.seeds.split(',')]:
        t = time.perf_counter()
        result, capture = measure(spec, seed, args.seconds, False, dev, t)
        line = {'workload': args.workload, 'seed': seed,
                'sweeps': result['attempted'] // spec['traffic']['chains']}
        runs = [('program', False, None)]
        if args.control:
            runs.append(('control', True, None))
        if args.faults:
            runs += [(f, False, f) for f in reference(spec).FAULTS]
        for name, control, fault in runs:
            t0 = time.perf_counter()
            numbers, failed, blocks = check_run(spec, capture, dev,
                                                control, fault)
            line[name] = {k: v['value'] for k, v in numbers.items()}
            line[name]['failed'] = failed
            line[name]['blocks'] = blocks
            line[name + '_check_s'] = time.perf_counter() - t0
        line['metrics'] = {k: v['value'] for k, v in result['metrics'].items()}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + '\n')
            out.flush()
        del capture
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
