"""Peak device memory and time of one HDP-LPCM sweep by latent update.

    python3 scripts/latent_scheme_memory.py [--n 2048,4096] [--chains 16]
        [--schemes exact,parallel,mala] [--sweeps 2] [--step 0.02]

Imports ``dynetlsm_tpu_torch`` from the checkout that holds this script
and, for each n of ``--n`` and each scheme of ``--schemes`` (default
exact, parallel, mala), builds the sticky HDP-LPCM (K = 25) on
bench.py's north-star community model at T = 10 and n nodes,
constant expected degree (``datasets.northstar_edge_lists``, made dense),
with ``entry.build_state_and_sweep(..., latent_update=scheme)`` on the
card, and runs two sweeps (``--sweeps``).  Each sweep's peak device
memory (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``, the state and network included) and its
host-clock seconds (synchronised), and each chain's share of accepted
position moves over the sweeps, are printed as one JSON line, with the
card's name and power limit.  ``--step`` sets every site's starting step
size (default: the sweep's own, 0.1).  A sweep that runs out of device
memory is recorded as such, with the allocator's message, and the next
case runs.  Needs a CUDA device.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import time

T, K = 10, 25


def card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--n', default='2048,3072,4096,8192')
    p.add_argument('--chains', type=int, default=16)
    p.add_argument('--schemes', default='exact,parallel,mala')
    p.add_argument('--sweeps', type=int, default=2)
    p.add_argument('--step', type=float, default=None)
    a = p.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('latent_scheme_memory: no CUDA device', file=sys.stderr)
        return 1
    from dynetlsm_tpu_torch.datasets import (
        network_of_edge_lists, northstar_edge_lists)
    from dynetlsm_tpu_torch.entry import build_state_and_sweep
    dev = torch.device('cuda', 0)
    name = card()
    for n in (int(v) for v in a.n.split(',')):
        Y = network_of_edge_lists(*northstar_edge_lists(T=T, n=n,
                                                        directed=False))
        for scheme in a.schemes.split(','):
            out = dict(card=name, root=root, T=T, n=n,
                       chains=a.chains, K=K, scheme=scheme, step=a.step,
                       sweeps=[])
            state = sweep = None
            try:
                state, sweep, gen = build_state_and_sweep(
                    Y, a.chains, K=K, device=dev, latent_update=scheme)
                if a.step is not None:
                    state = state.replace(
                        step_X=torch.full_like(state.step_X, a.step))
                for _ in range(a.sweeps):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    state = sweep(state, gen)
                    torch.cuda.synchronize()
                    out['sweeps'].append(dict(
                        seconds=time.perf_counter() - t0,
                        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9))
                out['finite'] = bool(torch.isfinite(state.logp).all())
                out['acceptance_by_chain'] = (
                    state.acc_X.mean(dim=(1, 2)) / a.sweeps).tolist()
            except torch.cuda.OutOfMemoryError as e:
                out['out_of_memory'] = str(e).splitlines()[0]
            del state, sweep
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
