"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and the objects are linked into
one shared library with a plain C interface, loaded through ``ctypes``.
The build runs at first use, into ``build/torch_kernels/`` beside the
package (listed in ``.gitignore``), under a name that hashes the sources,
their ``*.cuh`` headers and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.
``-fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise operators round them: the node-scan kernel's accept
decisions are compared bit for bit with its plain version.
"""
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'torch_kernels'
GENCODE = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = GENCODE + ('-std=c++17', '-O3', '-fmad=false', '-Xcompiler',
                        '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'node_scan_launch': [_P] * 13 + [_I] * 9 + [_F] * 2 + [_P],
    'node_scan_smem_bytes': [_I] * 6,
    'node_scan_threads': [_I] * 2,
    'node_scan_max_clusters': [_I] * 9,
    'pair_loglik_launch': [_P] * 7 + [_I] * 5 + [_P],
    'pair_loglik_blocks_per_sm': [_I] * 2,
    'dir_loglik_launch': [_P] * 7 + [_I] * 6 + [_P],
    'dir_loglik_blocks_per_sm': [_I] * 2,
}


def _nvcc():
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    path = shutil.which('nvcc')
    if path is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA '
                           'kernels are built from source at first use')
    return path


def sources():
    return sorted(CSRC.glob('*.cu'))


def headers():
    """The ``*.cuh`` the sources include: hashed with them, so an edited
    header rebuilds the library."""
    return sorted(CSRC.glob('*.cuh'))


def _run_all(cmds):
    """Run the commands at once; return their combined output, or raise
    with the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError('nvcc failed (rc=%d): %s\n%s'
                               % (p.returncode, ' '.join(c), out))
    return ''.join(outs)


def _build(srcs, so):
    """Compile each source to an object, all at once, then link ``so``
    (written under a temporary name and moved into place).  The objects
    are removed whether or not the build succeeds.  Returns nvcc's
    output."""
    tag = '%d' % os.getpid()
    objs = [so.with_name('%s.%s.%s.o' % (so.stem, p.stem, tag))
            for p in srcs]
    tmp = so.with_suffix('.so.%s.tmp' % tag)
    nvcc = _nvcc()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', str(o), str(p)]
                        for p, o in zip(srcs, objs)])
        log += _run_all([[nvcc, *GENCODE, '-shared', '-o', str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first if needed.  Attributes
    ``build_seconds`` (0.0 when reused) and ``build_log`` (nvcc's output,
    including ``-Xptxas -v`` register and shared-memory counts) describe
    the build."""
    srcs = sources()
    digest = hashlib.sha256()
    for p in srcs + headers():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / ('libdynetlsm_kernels_%s.so' % digest.hexdigest()[:16])
    log = ''
    seconds = 0.0
    if not so.exists():
        t0 = time.perf_counter()
        log = _build(srcs, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.build_seconds = seconds
    lib.build_log = log
    lib.path = str(so)
    return lib


def check_tensor(kernel, name, t, shape, dtype, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust their layout."""
    if t is None:
        raise ValueError('%s: %s is required (a %s tensor of shape %s)'
                         % (kernel, name, dtype, tuple(shape)))
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            '%s: %s must be a contiguous %s tensor of shape %s on %s, got '
            '%s %s on %s (contiguous=%s)'
            % (kernel, name, dtype, tuple(shape), device, t.dtype,
               tuple(t.shape), t.device, t.is_contiguous()))


def check_launch(name, rc):
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError('%s: CUDA error %d at launch' % (name, rc))


def stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream
