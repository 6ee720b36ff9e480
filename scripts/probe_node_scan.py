"""Where one phase step of the node-scan kernel spends its cycles.

    python3 scripts/probe_node_scan.py [--clusters 1,2,4]
    python3 scripts/probe_node_scan.py --mode split --n 8192 --chains 16
                                       --clusters 2,4,8,16 [--directed 0]
                                       [--root DIR]

Needs an NVIDIA card and nvcc.  Copies the kernel source of the checkout
at DIR (default: this one), ``dynetlsm_tpu_torch/csrc/node_scan.cu``, into
``build/probe_node_scan/``, inserts ``clock64()`` probes at the points of
a step listed below (lane 0 of every warp of chain 0's first block, nodes
100-163), builds it as that checkout's ``ops/cuda_lib.py`` builds the
kernels, and runs a scan through its ``node_scan_cuda`` with that library
in place of the kernel library: by default the north star (T=10, n=500,
32 chains, mixture prior, the inputs of ``scripts/time_torch_scan.py``) in
the resident mode; with ``--mode split`` the split-field mode at ``--n``
and ``--chains``; undirected and directed (``--directed``), at each
cluster size.  Prints one JSON line per run: the CUDA-event ms of one
launch without probes, the card's count of clusters it runs at once, and
the median cycles, from the step's start, at which

* ``terms_done_max`` / ``_min``: the group warps have their register levels
  (the latest and earliest warp),
* ``prior_done``: the prior warp has the prior terms (the pipelined
  split-field mode: it has finished the previous step),
* ``stores_done_g0``: group 0's first warp has stored its exchange values
  into the peers' buffers (resident clusters: every lane's value; the
  kernel before the split-field redesign likewise in both modes; the
  pipelined split-field mode: the prior warp, its block's one partial a
  time, after the levels over its block's lanes),
* ``pre_barrier_max``: the exchange values are stored,
* ``named_done_g0`` / ``post_barrier_g0``: group 0's reducing warp has
  passed its named barrier / the mbarrier of its peers' values (the
  pipelined split-field mode: the prior warp starts to finish the step /
  has its peers' partials),
* ``reduce_accept_done_g0``: it has decided the accepts,
* ``sync_done``: the block barrier that ends the step is passed,

``step_cycles_median``, the cycles from one step's start to the next, and
``exchange_cycles``, post_barrier_g0 - terms_done_max: from the last
warp's register levels to the peers' values in this block (the stores,
the named barrier, split-field also the block's own levels, and the wait
for the peers).  The pipelined split-field mode finishes a step during the
next one, so its finishing events count from the finished step's start
and may pass ``step_cycles_median``: the step is short of its partner
terms only while the finishing warp's chain is.  ``clock_ghz`` is step
cycles over the probe-free ms per step: about the SM clock when the chains
run in one wave, half of it in two.  The probe points are found by anchors
in the source, in the kernel since the split-field redesign or before it
(the parent of that change); it stops if the ``.cu`` has neither.
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
# (event, anchor, insert after the anchor) of the kernel since the
# split-field redesign (its resident loop, then its pipelined split-field
# loop, whose reducing warps finish step s - 1 during step s: those events
# count from step s - 1's start) and of the kernel before it; events 0-7
# as the module docstring lists them: 0 step start, 1 terms done,
# 2 pre-barrier, 3 post-barrier, 4 accept done, 5 sync done, 6 named done
# (split-field: the reducing warp starts the step), 7 stores done
POINTS = {
    'split partials': [
        (0, '      const int xoff = phase * H * R;  // double-buffered by step '
            'parity\n', True),
        (1, '          float* slot = xbuf + xoff + m * R + r;', False),
        (7, 'if (q != rank) st_async(slot, v, &mbar[phase], q);\n', True),
        (2, '      if (warp != pw && g < th) {\n', False),
        (6, '          if (B > 1) mbar_wait(&mbar[phase], j & 1);', False),
        (3, '      if (warp != pw && w == 0) {\n', False),
        (4, '      if (phase == 1) cp_async_wait_all();\n      __syncthreads();'
            '\n    }\n  }\n', False),
        (0, '    for (int s = 0; s <= 2 * n; ++s) {\n'
            '      const int j = s >> 1, phase = s & 1;\n', True),
        (1, '          xbuf[phase * H * Rl + m * Rl + rl] =\n'
            '              lane_value(j, phase, m, bo_rj, bi_rj);\n', True),
        (6, '      const int th = (T - phase + 1) / 2;\n'
            '      const float* xb = xbuf + phase * H * Rl;\n', True),
        (7, '      for (int m = lane; m < th; m += 32) prior_site(j, phase, m);\n'
            '      __syncwarp();', False),
        (3, '      for (int m = lane; m < th; m += 32)\n'
            '        accept_site(', False),
        (4, '        accept_site(j, phase, m, cluster_levels(pb + m * B, B));'
            '\n', True),
        (2, "      // node j+1's inputs have landed before node j+1 starts\n"
            "      if (s < 2 * n && phase == 1) cp_async_wait_all();", False)],
    'lane values': [
        (0, '      const float* e_ph = sc + st.eps + phase * T * d;\n', True),
        (2, '      if (warp != pw && g < th) {\n', False),
        (4, "      // node j+1's inputs have landed", False),
        (1, '          float* slot = xbuf + xoff + m * R + r;', False),
        (7, 'if (q != rank) st_async(slot, v, &mbar[phase], q);\n', True),
        (6, '          if (B > 1) mbar_wait(&mbar[phase], j & 1);', False),
        (3, '      if (warp != pw && w == 0) {\n', False)],
}


def _insert(src, anchor, text, after=False):
    if src.count(anchor) != 1:
        raise SystemExit('probe_node_scan: the kernel source has changed; '
                         'anchor not found once: %r' % anchor)
    return src.replace(anchor, anchor + text if after else text + anchor)


def probed_source(root=ROOT):
    src = open(os.path.join(root, 'dynetlsm_tpu_torch', 'csrc',
                            'node_scan.cu')).read()
    kind = 'split partials' if 'pbuf' in src else 'lane values'
    src = _insert(src, 'namespace cg = cooperative_groups;\n',
                  '__device__ long long* g_probe;\n', after=True)
    src = _insert(src, '  const int tid = threadIdx.x;\n',
                  '  long long* const gp = g_probe;\n', after=True)
    for event, anchor, after in POINTS[kind]:
        src = _insert(src, anchor, PROBE % event, after=after)
    src = src.replace('      __syncthreads();\n    }\n  }\n',
                      '      __syncthreads();\n' + PROBE % 5
                      + '    }\n  }\n')
    return src + ('\nextern "C" int probe_set(long long* p) {\n'
                  '  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));'
                  '\n}\n')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--clusters', default='1,2,4')
    parser.add_argument('--mode', default='resident',
                        choices=('resident', 'split'))
    parser.add_argument('--n', type=int, default=500)
    parser.add_argument('--chains', type=int, default=32)
    parser.add_argument('--directed', default='0,1',
                        help='comma-separated 0 (undirected), 1 (directed)')
    parser.add_argument('--root', default=ROOT,
                        help='the checkout whose kernel is probed')
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
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
        f.write(probed_source(root))
    pipelined = 'finish_step' in open(os.path.join(
        root, 'dynetlsm_tpu_torch', 'csrc', 'node_scan.cu')).read()
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
    split = args.mode == 'split'
    for directed in (bool(int(v)) for v in args.directed.split(',')):
        scan_args, mixture, radii = time_torch_scan._inputs(
            torch, ns, args.chains, directed, n=args.n)
        C, T, n, d = scan_args[1].shape
        for cluster in [int(b) for b in args.clusters.split(',')]:
            mode = {'mode': 'split'} if split else {}
            try:
                W, B, _ = ns.cuda_layout(C, T, n, d, dev.index, directed,
                                         True, False, cluster, **mode)
            except ValueError as e:
                print(json.dumps({'directed': directed, 'cluster': cluster,
                                  'refused': str(e)}), flush=True)
                continue

            def launch():
                ns.node_scan_cuda(*scan_args, *mixture, radii=radii,
                                  cluster=cluster, **mode)

            lib.probe_set(None)
            launch()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reps = 10 if n <= 2048 else 2
            start.record()
            for _ in range(reps):
                launch()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / reps
            probe = torch.zeros(STEPS * 2 * 32 * EVENTS, dtype=torch.int64,
                                device=dev)
            lib.probe_set(probe.data_ptr())
            launch()
            torch.cuda.synchronize()
            lib.probe_set(None)
            # (the kernel before the split-field redesign: one count for
            # both modes)
            nw = (lib.node_scan_threads(T, W, int(split))
                  if len(lib.node_scan_threads.argtypes) == 3
                  else lib.node_scan_threads(T, W)) // 32
            pw = nw - 1
            p = probe.cpu().numpy().reshape(STEPS, 2, 32, EVENTS)[:, :, :nw]
            p = p.astype(np.float64)
            rel = p - p[:, :, :1, :1]

            def med(x):
                return float(np.median(x))

            steps = med(np.diff(p[:, :, 0, 0].reshape(-1)))
            terms_max = med(rel[..., :pw, 1].max(-1))
            # the warp that finishes a step: group 0's reducing warp, or
            # in the pipelined split-field mode the prior warp
            f = pw if split and pipelined else 0
            post = med(rel[:, :, f, 3])
            print(json.dumps({
                'root': root, 'mode': args.mode, 'n': n, 'chains': C,
                'directed': directed, 'warps': W, 'cluster': B, 'ms': ms,
                'us_per_step': 1e3 * ms / (2 * n),
                'max_clusters': lib.node_scan_max_clusters(
                    T, n, d, ns.partner_pad(n), W, B, int(directed), 1, 0,
                    int(split)),
                'step_cycles_median': steps,
                'terms_done_max': terms_max,
                'terms_done_min': med(rel[..., :pw, 1].min(-1)),
                'prior_done': med(rel[:, :, pw, 2]),
                'stores_done_g0': med(rel[:, :, f, 7]),
                'pre_barrier_max': med(rel[..., 2].max(-1)),
                'named_done_g0': med(rel[:, :, f, 6]),
                'post_barrier_g0': post,
                'reduce_accept_done_g0': med(rel[:, :, f, 4]),
                'sync_done': med(rel[:, :, 0, 5]),
                'exchange_cycles': post - terms_max,
                'clock_ghz': steps / (1e6 * ms / (2 * n))}), flush=True)
        del scan_args, mixture, radii
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
