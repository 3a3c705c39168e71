"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Every kernel source in ``csrc/`` exports a plain C interface and is
compiled on its own into a shared library for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o cuda/build/lib<name>_<hash>.so csrc/<name>.cu

at first use, named by the hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header never
meets a stale binary.  ``build`` starts one nvcc process per missing
library, all at once, and waits for them with a timeout; ``load`` returns a library as a ``ctypes.CDLL``, building all
of them at its first call.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
BUILD_TIMEOUT_S = 300
# the sources, by the name of their module in this package
SOURCES = ("osc_kernel", "fbdelay_kernel", "filter_kernel", "fm_kernel",
           "filter_float_kernel", "unpack_kernel", "rows_kernel",
           "expand_kernel")

build_log = {}               # source name -> nvcc output of its build
_handles = {}                # source name -> loaded ctypes library
# launch counting: the counts of the graph capture in progress on each
# thread, and the lock around the wrappers' shared counts
_capturing = threading.local()
_count_lock = threading.Lock()
# one build at a time in a process (a renderer's warm-up thread and a
# wrapper's first call may both start one; they share temporary names)
_build_lock = threading.Lock()


def lib_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            h.update(src.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, digest[:12]))


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source on the machine with the card")
    return nvcc


def build(verbose=False):
    """Compiles every library of SOURCES that is not built yet, one nvcc
    process per source, all started together; returns {name: path}.
    Raises if nvcc is missing, fails, or runs past BUILD_TIMEOUT_S
    (the other builds are stopped then).  Threads take turns."""
    with _build_lock:
        return _build(verbose)


def _build(verbose):
    paths = {n: lib_path(n) for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = "%s.%d.tmp" % (paths[n], os.getpid())
            cmd = [nvcc] + NVCC_FLAGS \
                + (["-Xptxas", "-v"] if verbose else []) \
                + ["-o", tmp, os.path.join(CSRC_DIR, n + ".cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        deadline = time.monotonic() + BUILD_TIMEOUT_S
        for n in todo:
            p, tmp = procs[n]
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            build_log[n] = out
            if p.returncode:
                raise RuntimeError("nvcc failed on %s.cu (%d):\n%s"
                                   % (n, p.returncode, out))
            os.replace(tmp, paths[n])
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return paths


def load(name, bind):
    """The loaded library of source `name`; the first use builds every
    library not built yet (in parallel).  bind(lib) sets its functions'
    ctypes signatures once."""
    lib = _handles.get(name)
    if lib is None:
        lib = ctypes.CDLL(build()[name])
        bind(lib)
        _handles[name] = lib
    return lib


def launch_check(err, what):
    """Raises if a kernel's C entry point returned a CUDA error (the
    value of cudaGetLastError() after its launch)."""
    if err:
        raise RuntimeError("%s kernel launch failed: cudaError %d"
                           % (what, err))


def count_launch(fn, kind=None):
    """Counts one kernel launch of wrapper `fn` (and of its `kind`, or of
    each kind of a tuple, for a wrapper with ``kind_launches``): into the
    graph capture in progress on this thread (``captured_launches``),
    else into the wrapper's counts."""
    counts = getattr(_capturing, "counts", None)
    if counts is None:
        add_launches({(fn, kind): 1})
    else:
        counts[(fn, kind)] = counts.get((fn, kind), 0) + 1


def add_launches(counts):
    """Adds {(wrapper, kind or None): launches} to the wrappers' counts
    (a graph launch adds the launches captured in it)."""
    with _count_lock:
        for (fn, kind), n in counts.items():
            fn.launches += n
            for k in (() if kind is None else (kind,)
                      if isinstance(kind, str) else kind):
                fn.kind_launches[k] += n


@contextlib.contextmanager
def captured_launches():
    """While a graph is captured on this thread (which launches nothing),
    its kernel launches are counted into the dict that this yields, not
    into the wrappers' counts; other threads count as before."""
    prev = getattr(_capturing, "counts", None)
    _capturing.counts = counts = {}
    try:
        yield counts
    finally:
        _capturing.counts = prev


def check_tensor(t, what, name, dtype, shape, device):
    """Raises unless `t` is a contiguous tensor of `dtype` and `shape`
    on `device`."""
    if t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError("%s: %s must be a contiguous %s tensor of shape "
                         "%s on %s, got %s %s on %s"
                         % (what, name, dtype, tuple(shape), device,
                            t.dtype, tuple(t.shape), t.device))
