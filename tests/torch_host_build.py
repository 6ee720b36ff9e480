"""The host builds of the port's CUDA kernels, for the tests that run the
kernels' own source on the CPU.

:func:`kernel_source` cuts a ``.cu`` (or a header) of
``dynetlsm_tpu_torch/csrc/`` to what runs on the device: without the CUDA
headers and the ``// ---- inline PTX`` section, up to its
``// ---- launch`` section, its dynamic shared memory taken from the host
block.  :func:`build` compiles a host source of ``tests/`` with g++ around
those cuts and ``tests/cuda_host.h``, which stands in for the intrinsics
(each CUDA thread a fiber), and loads it.
"""
import ctypes
import pathlib
import shutil
import subprocess

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
CSRC = TESTS.parent / 'dynetlsm_tpu_torch' / 'csrc'


def kernel_source(path):
    """A .cu up to its launch section (or a header), without the CUDA
    headers and the inline PTX, its shared memory taken from the host
    block."""
    src = path.read_text()
    for include in ('#include <cooperative_groups.h>\n',
                    '#include <cuda_runtime.h>\n'):
        src = src.replace(include, '')
    if '// ---- inline PTX' in src:
        src = (src[:src.index('// ---- inline PTX')]
               + src[src.index('// ---- end of inline PTX'):])
    src = src.replace('extern __shared__ __align__(16) float smem[];',
                      'float* smem = host_smem();')
    if '// ---- launch' in src:
        src = src[:src.index('// ---- launch')]
    return src


def build(tmp_path_factory, host, sources=()):
    """``tests/<host>`` (or the path ``host``) built with g++ around the
    kernel part of each of ``sources`` (files of ``csrc/``: a ``.cu`` as
    ``<stem>_kernel.inc``, a header under its own name); the loaded
    library."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the kernel source for the host')
    out = tmp_path_factory.mktemp(pathlib.Path(host).stem)
    for name in sources:
        path = CSRC / name
        dest = name if path.suffix == '.cuh' else path.stem + '_kernel.inc'
        (out / dest).write_text(kernel_source(path))
    so = out / 'lib.so'
    run = subprocess.run(
        [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-w', '-fPIC',
         '-shared', '-I', str(out), '-I', str(TESTS), '-o', str(so),
         str(TESTS / host)],
        capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    return ctypes.CDLL(str(so))
