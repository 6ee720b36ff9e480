"""Count the instructions of the node-scan kernel's partner-term loop.

    python3 scripts/node_scan_sass.py [--out DIR]

Builds the port's kernel library (nvcc, on a machine with the CUDA
toolkit), disassembles it with ``cuobjdump -sass`` (the helpers of
``scripts/loglik_sass.py``) and prints one JSON line per instantiation of
``node_scan_kernel`` (directed, mixture prior, tempered, split-field): the
kernel's instructions in all and, for its partner-term loop (the loop over
a lane's chunks of four partners in ``lane_chunks``, compiled for d = 2:
of the innermost loops around a ``MUFU.EX2``, the one with four partner
terms on its path and the fewest instructions), the instructions on the
loop's fall-through path (the loop body without the blocks that an
unconditional forward branch inside it skips: an alternative copy of a
term, or the fast path of an accurate square root, whose slow path is
counted in its place), the ``MUFU`` instructions among them by kind, the
partner terms (one ``MUFU.EX2`` per softplus: two a term undirected, four
directed) and so the instructions and MUFU instructions per partner term
that ``chip_smoke.py``'s ``NODE_SCAN_SASS`` holds.  The count is static:
a special-case branch that is rarely taken counts as if it were.  With
``--out`` the whole disassembly is written there as
``node_scan_sass.txt``.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from loglik_sass import _functions, _opcode  # noqa: E402

FLAGS = ('directed', 'mixture', 'tempered', 'split')


def _loops(instrs):
    """(first, last) index of every backward-branch loop."""
    at = {addr: k for k, (addr, _) in enumerate(instrs)}
    out = []
    for k, (_, text) in enumerate(instrs):
        m = re.search(r'\bBRA\b.*?0x([0-9a-f]+)', text)
        if m and int(m.group(1), 16) in at and at[int(m.group(1), 16)] <= k:
            out.append((at[int(m.group(1), 16)], k))
    return out


def _path(instrs, first, last):
    """The opcodes of the loop body's fall-through path: without the
    instructions an unconditional forward branch inside it jumps over."""
    at = {addr: k for k, (addr, _) in enumerate(instrs)}
    skip = set()
    for k in range(first, last):
        text = instrs[k][1]
        m = re.match(r'BRA\b.*?0x([0-9a-f]+)', text)
        if m and int(m.group(1), 16) in at:
            target = at[int(m.group(1), 16)]
            if k < target <= last:
                skip.update(range(k + 1, target))
    return [_opcode(instrs[k][1]) for k in range(first, last + 1)
            if k not in skip]


def describe(name, instrs):
    flags = [f == '1' for f in re.findall(r'Lb([01])E', name)[:4]]
    row = dict(zip(FLAGS, flags), function=name, instructions=len(instrs))
    ex2_per_term = 4 if row['directed'] else 2
    best = None
    loops = _loops(instrs)
    for first, last in loops:
        if any(f >= first and l <= last and (f, l) != (first, last)
               and any(_opcode(t).startswith('MUFU.EX2')
                       for _, t in instrs[f:l + 1])
               for f, l in loops):
            continue
        path = _path(instrs, first, last)
        ex2 = sum(op.startswith('MUFU.EX2') for op in path)
        if ex2 != 4 * ex2_per_term:
            continue
        if best is None or len(path) < len(best):
            best = path
    if best is None:
        return row
    mufu = collections.Counter(op for op in best if op.startswith('MUFU'))
    row.update(loop_instructions=len(best), loop_mufu=dict(mufu),
               loop_terms=4, instructions_per_term=len(best) / 4,
               mufu_per_term=sum(mufu.values()) / 4)
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    from dynetlsm_tpu_torch.ops import cuda_lib
    lib = cuda_lib.library()
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', lib.path], capture_output=True,
                          text=True, check=True).stdout
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'node_scan_sass.txt'), 'w') as f:
            f.write(sass)
    for name, instrs in sorted(_functions(sass).items()):
        if 'node_scan_kernel' in name:
            print(json.dumps(describe(name, instrs)), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
