"""Where one phase step of the node-scan kernel spends its cycles.

    python3 scripts/probe_node_scan.py [--clusters 1,2,4]

Needs an NVIDIA card and nvcc.  Copies ``dynetlsm_tpu_torch/csrc/
node_scan.cu`` into ``build/probe_node_scan/``, inserts ``clock64()``
probes at the points of a step listed below (lane 0 of every warp of chain
0's first block, nodes 100-163), builds it as ``ops/cuda_lib.py`` builds
the kernels, and runs the north-star scan through ``node_scan_cuda`` with
that library in place of the kernel library (T=10, n=500, 32 chains, mixture
prior, the inputs of ``scripts/time_torch_scan.py``), undirected and
directed, at each cluster size.  Prints one JSON line per run: the CUDA-
event ms of one launch without probes, the card's count of clusters it
runs at once, and the median cycles, from the step's start, at which

* ``terms_done_max`` / ``_min``: the group warps have their register levels
  (the latest and earliest warp),
* ``prior_done``: the prior warp has the prior terms,
* ``pre_barrier_max``: the exchange values are stored,
* ``named_done_g0`` / ``post_barrier_g0``: group 0's reducing warp has
  passed its named barrier / the mbarrier of its peers' values,
* ``reduce_accept_done_g0``: it has decided the accepts,
* ``sync_done``: the block barrier that ends the step is passed,

and ``step_cycles_median``, the cycles from one step's start to the next.
``clock_ghz`` is step cycles over the probe-free ms per step: about the SM
clock when the chains run in one wave, half of it in two.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'build', 'probe_node_scan')
STEPS, FIRST = 64, 100   # probed nodes FIRST .. FIRST + STEPS - 1
EVENTS = 8
PROBE = ('{ if (gp && c == 0 && rank == 0 && lane == 0 && j >= %d '
         '&& j < %d) gp[(((j - %d) * 2 + phase) * 32 + warp) * %d + (%%d)] '
         '= clock64(); }\n' % (FIRST, FIRST + STEPS, FIRST, EVENTS))


def _insert(src, anchor, text, after=False):
    if src.count(anchor) != 1:
        raise SystemExit('probe_node_scan: the kernel source has changed; '
                         'anchor not found once: %r' % anchor)
    return src.replace(anchor, anchor + text if after else text + anchor)


def probed_source():
    src = open(os.path.join(ROOT, 'dynetlsm_tpu_torch', 'csrc',
                            'node_scan.cu')).read()
    src = _insert(src, 'namespace cg = cooperative_groups;\n',
                  '__device__ long long* g_probe;\n', after=True)
    src = _insert(src, '  const int tid = threadIdx.x;\n',
                  '  long long* const gp = g_probe;\n', after=True)
    src = _insert(src, '      const float* e_ph = sc + st.eps + phase * T * d;'
                  '\n', PROBE % 0, after=True)
    src = _insert(src, '          float* slot = xbuf + xoff + m * R + r;',
                  PROBE % 1)
    src = _insert(src, '      if (warp != pw && g < th) {\n', PROBE % 2)
    src = _insert(src, '          if (B > 1) mbar_wait(&mbar[phase], j & 1);',
                  PROBE % 6)
    src = _insert(src, '      if (warp != pw && w == 0) {\n', PROBE % 3)
    src = _insert(src, "      // node j+1's inputs have landed", PROBE % 4)
    src = _insert(src, '      __syncthreads();\n    }\n  }\n',
                  '', after=True).replace(
        '      __syncthreads();\n    }\n  }\n',
        '      __syncthreads();\n' + PROBE % 5 + '    }\n  }\n')
    return src + ('\nextern "C" int probe_set(long long* p) {\n'
                  '  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));'
                  '\n}\n')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--clusters', default='1,2,4')
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, 'scripts'))
    import torch
    if not torch.cuda.is_available():
        print('probe_node_scan: no CUDA device')
        return 1
    from dynetlsm_tpu_torch.ops import cuda_lib
    from dynetlsm_tpu_torch.ops import node_scan as ns
    import time_torch_scan
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, 'node_scan.cu')
    so = os.path.join(OUT, 'libnode_scan.so')
    with open(cu, 'w') as f:
        f.write(probed_source())
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, '-shared', '-o',
                    so, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if name.startswith('node_scan'):
            getattr(lib, name).argtypes = argtypes
    lib.probe_set.argtypes = [ctypes.c_void_p]
    # node_scan_cuda launches the probed kernel
    cuda_lib.library = lambda: lib
    dev = torch.device('cuda', 0)
    for directed in (False, True):
        scan_args, mixture, radii = time_torch_scan._inputs(
            torch, ns, 32, directed)
        C, T, n, d = scan_args[1].shape
        for cluster in [int(b) for b in args.clusters.split(',')]:
            W, B = ns.cuda_layout(C, T, n, d, dev.index, directed, True,
                                  False, cluster)

            def launch():
                ns.node_scan_cuda(*scan_args, *mixture, radii=radii,
                                  cluster=cluster)

            lib.probe_set(None)
            launch()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                launch()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 10
            probe = torch.zeros(STEPS * 2 * 32 * EVENTS, dtype=torch.int64,
                                device=dev)
            lib.probe_set(probe.data_ptr())
            launch()
            torch.cuda.synchronize()
            lib.probe_set(None)
            nw = lib.node_scan_threads(T, W) // 32
            pw = nw - 1
            p = probe.cpu().numpy().reshape(STEPS, 2, 32, EVENTS)[:, :, :nw]
            p = p.astype(np.float64)
            rel = p - p[:, :, :1, :1]

            def med(x):
                return float(np.median(x))

            steps = med(np.diff(p[:, :, 0, 0].reshape(-1)))
            print(json.dumps({
                'directed': directed, 'warps': W, 'cluster': B, 'ms': ms,
                'max_clusters': lib.node_scan_max_clusters(
                    T, n, d, ns.partner_pad(n), W, B, int(directed), 1, 0),
                'step_cycles_median': steps,
                'terms_done_max': med(rel[..., :pw, 1].max(-1)),
                'terms_done_min': med(rel[..., :pw, 1].min(-1)),
                'prior_done': med(rel[:, :, pw, 2]),
                'pre_barrier_max': med(rel[..., 2].max(-1)),
                'named_done_g0': med(rel[:, :, 0, 6]),
                'post_barrier_g0': med(rel[:, :, 0, 3]),
                'reduce_accept_done_g0': med(rel[:, :, 0, 4]),
                'sync_done': med(rel[:, :, 0, 5]),
                'clock_ghz': steps / (1e6 * ms / (2 * n))}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
