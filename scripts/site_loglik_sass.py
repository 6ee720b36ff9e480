"""Count the instructions of the site kernel's partner loop.

    python3 scripts/site_loglik_sass.py [--out DIR]

Builds the port's kernel library (nvcc, on a machine with the CUDA
toolkit), disassembles it with ``cuobjdump -sass`` (the helpers of
``scripts/loglik_sass.py`` and ``scripts/node_scan_sass.py``) and prints
one JSON line per instantiation of ``site_loglik_kernel`` (directed,
compiled for d = 2 or for any d): the kernel's instructions in all and,
for its partner loop (the innermost loop around a ``MUFU.EX2``: a lane's
words of four partners in ``row_chunk``), the instructions on the
shortest path through the loop body, the ``MUFU`` instructions among them
by kind, the partner terms (one ``MUFU.EX2`` per softplus: two a term
undirected, both candidates; four directed) and so the instructions and
MUFU instructions per partner term.  The shortest path takes every
forward branch that skips instructions: the word load of the adjacency
(not the byte-wise load beside it), the fast path of each accurate square
root and division (not the call of its slow path), and no special-case
fix-up of a logarithm.  No pass through the loop issues fewer, so the
issue bound of a launch, those instructions x the partner terms (C T n (n
- 1) a sweep) over 132 SMs x 128 lanes x the SM clock, is a bound.  With
``--out`` the whole disassembly is written there as
``site_loglik_sass.txt``.
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
from node_scan_sass import _loops  # noqa: E402

BRANCH = re.compile(r'(@!?U?P\w+\s+)?BRA\b.*?0x([0-9a-f]+)')


def _shortest_path(instrs, first, last):
    """The opcodes of the loop body's shortest path from its first
    instruction to its backward branch ``last``: a forward branch within
    the body may be taken, a predicated one may fall through, EXIT and RET
    end no pass."""
    at = {addr: k for k, (addr, _) in enumerate(instrs)}
    cost, step = {last: 1}, {}
    for k in range(last - 1, first - 1, -1):
        text = instrs[k][1]
        m = BRANCH.match(text)
        succ = []
        if m:
            target = at.get(int(m.group(2), 16))
            if target is not None and k < target <= last:
                succ.append(target)
            if m.group(1) is not None:
                succ.append(k + 1)
        elif not re.match(r'(EXIT|RET)\b', text):
            succ.append(k + 1)
        step[k] = min(succ, key=cost.get, default=None)
        cost[k] = (float('inf') if step[k] is None
                   else 1 + cost[step[k]])
    path, k = [], first
    while k != last:
        path.append(_opcode(instrs[k][1]))
        k = step[k]
    return path + [_opcode(instrs[last][1])]


def describe(name, instrs):
    directed, d = re.search(r'ILb([01])ELi(\d)E', name).groups()
    directed = directed == '1'
    row = {'directed': directed, 'compiled_for_d': int(d) or 'any',
           'function': name, 'instructions': len(instrs)}
    ex2_per_term = 4 if directed else 2
    loops = _loops(instrs)
    best = None
    for first, last in loops:
        path = _shortest_path(instrs, first, last)
        ex2 = sum(op.startswith('MUFU.EX2') for op in path)
        if ex2 == 0 or ex2 % ex2_per_term:
            continue
        # the innermost such loop
        if best is None or last - first < best[1] - best[0]:
            best = (first, last, path, ex2 // ex2_per_term)
    if best is None:
        return row
    _, _, path, terms = best
    mufu = collections.Counter(op for op in path if op.startswith('MUFU'))
    row.update(loop_instructions=len(path), loop_mufu=dict(mufu),
               loop_terms=terms, instructions_per_term=len(path) / terms,
               mufu_per_term=sum(mufu.values()) / terms)
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
        with open(os.path.join(args.out, 'site_loglik_sass.txt'), 'w') as f:
            f.write(sass)
    for name, instrs in sorted(_functions(sass).items()):
        if 'site_loglik_kernel' in name:
            print(json.dumps(describe(name, instrs)), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
