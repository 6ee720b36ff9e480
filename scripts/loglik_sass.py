"""Count the instructions of the log-likelihood kernels' inner loops.

    python3 scripts/loglik_sass.py [--out DIR]

Builds the port's kernel library (nvcc, on a machine with the CUDA
toolkit), disassembles it with ``cuobjdump -sass`` and prints one JSON line
per instantiation of ``pair_loglik_kernel`` and ``dir_loglik_kernel`` (by
candidate count, compiled for d = 2 or for any d, whole network or the
row-range mode, ``row_range``): the kernel's
instructions in all, and for its hot loop (the innermost loop
around the first ``MUFU.EX2``: the loop over a tile's passes, or over the
tiles where the compiler unrolled the passes) the instructions of its body,
the ``MUFU`` instructions among them by kind, the softplus evaluations
(one ``MUFU.EX2`` each), the dyads that makes (one softplus per dyad and
intercept; two per dyad and directed candidate) and so the instructions
and MUFU instructions per dyad that ``chip_smoke.py``'s ``LOGLIK_SASS``
holds (the d = 2 instantiations').  The count is static: a nested loop
over the latent dimensions is counted once, and a branch not taken (the
byte-wise adjacency load where rows are not whole words) counts too.
With ``--out`` the whole disassembly is written there as
``loglik_sass.txt``.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys

INSTR = re.compile(r'^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);')


def _functions(sass):
    """{mangled name: [(address, text), ...]} of a cuobjdump -sass dump."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = INSTR.match(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _opcode(text):
    """The opcode of an instruction, without its predicate."""
    words = text.split()
    return words[1] if words[0].startswith('@') else words[0]


def _hot_loop(instrs):
    """(first, last) index of the innermost backward-branch loop around the
    first MUFU.EX2, or None."""
    at = {addr: k for k, (addr, _) in enumerate(instrs)}
    ex2 = next((k for k, (_, t) in enumerate(instrs)
                if _opcode(t).startswith('MUFU.EX2')), None)
    if ex2 is None:
        return None
    loops = []
    for k, (_, text) in enumerate(instrs):
        m = re.search(r'\bBRA\b.*?0x([0-9a-f]+)', text)
        if m and int(m.group(1), 16) in at:
            first = at[int(m.group(1), 16)]
            if first <= ex2 <= k:
                loops.append((k - first, first, k))
    return min(loops)[1:] if loops else None


def describe(name, instrs):
    kind = 'pair_loglik' if 'pair_loglik' in name else 'dir_loglik'
    n_cand, d = map(int, re.search(r'ILi(\d)ELi(\d)E', name).groups())
    ranged = re.search(r'ILi\dELi\dELb1E', name) is not None
    row = {'kernel': kind, 'n_cand': n_cand, 'compiled_for_d': d or 'any',
           'row_range': ranged, 'function': name,
           'instructions': len(instrs)}
    loop = _hot_loop(instrs)
    if loop is None:
        return row
    body = [_opcode(t) for _, t in instrs[loop[0]:loop[1] + 1]]
    mufu = collections.Counter(op for op in body if op.startswith('MUFU'))
    softplus = sum(v for op, v in mufu.items() if op.startswith('MUFU.EX2'))
    dyads = softplus / (n_cand if kind == 'pair_loglik' else 2 * n_cand)
    row.update(loop_instructions=len(body), loop_mufu=dict(mufu),
               loop_softplus=softplus, loop_dyads=dyads,
               loop_barriers=sum(op.startswith('BAR') for op in body),
               instructions_per_dyad=len(body) / dyads,
               mufu_per_dyad=sum(mufu.values()) / dyads)
    return row


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, here)
    from dynetlsm_tpu_torch.ops import cuda_lib
    lib = cuda_lib.library()
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', lib.path], capture_output=True,
                          text=True, check=True).stdout
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'loglik_sass.txt'), 'w') as f:
            f.write(sass)
    for name, instrs in sorted(_functions(sass).items()):
        if 'loglik_kernel' in name:
            print(json.dumps(describe(name, instrs)), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
