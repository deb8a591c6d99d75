"""Build, load and probe the port's CUDA kernels.

Counterpart of ``paddle_tpu/ops/pallas/support.py``. Every kernel of the
port is a CUDA C++ source under ``paddle_tpu_torch/csrc/`` with a plain C
interface. At first use each source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library under ``paddle_tpu_torch/_build/``
and loaded with ``ctypes``; sources build in parallel, one ``nvcc`` each.
A library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
never confused with an old build.

``ensure_kernels(device)`` is the counterpart of ``pallas_supported``: it
builds every source and launches the probe kernel (``x + 1`` over
``[8, 128]`` float32) once per device. Where the Pallas probe answers False
so that callers can fall back, this one raises: a tensor on the card reaches
its kernel or an exception, never a fallback.

Each kernel wrapper owns a ``LaunchCounter`` that it increments where it
launches its kernel, so a run can show that it went through the kernels.
A launch on a stream that is capturing a CUDA graph runs nothing: inside
``recording_launches(stream)`` it is recorded instead of counted, and the
graph's owner adds the record on every replay (``count_replay``), so that
``launch_counts()`` counts the kernels the card ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("probe", "flash_attention", "flash_attention_bwd",
           "fused_optimizer", "conv2d_bn_act", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class LaunchCounter:
    """A plain count of kernel launches, safe to bump from any thread."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def inc(self) -> None:
        if _recordings and _record(self.name):
            return
        with self._lock:
            self._n += 1

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


# kernel name -> its wrapper's counter (filled as wrapper modules import)
COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


# capturing stream (its cudaStream_t as an int) -> kernel name -> launches
# recorded there. A kernel launches on the current stream, which is the
# capture stream on the capturing thread and on autograd's device thread
# alike (the backward runs on its forward's stream).
_recordings: Dict[int, Dict[str, int]] = {}
_recordings_lock = threading.Lock()


def _record(name: str) -> bool:
    rec = _recordings.get(torch.cuda.current_stream().cuda_stream)
    if rec is None:
        return False
    with _recordings_lock:
        rec[name] = rec.get(name, 0) + 1
    return True


@contextmanager
def recording_launches(stream: "torch.cuda.Stream") -> Iterator[Dict]:
    """Record, not count, the launches made on ``stream`` inside the
    block (a graph capture): yields the record, kernel name -> launches."""
    rec: Dict[str, int] = {}
    with _recordings_lock:
        _recordings[stream.cuda_stream] = rec
    try:
        yield rec
    finally:
        with _recordings_lock:
            del _recordings[stream.cuda_stream]


def count_replay(launches: Dict[str, int]) -> None:
    """Count one replay of a graph that recorded ``launches``."""
    for name, n in launches.items():
        launch_counter(name).add(n)


def reset_launch_counts() -> None:
    for counter in COUNTERS.values():
        counter.reset()


def launch_counts() -> Dict[str, int]:
    return {name: c.value for name, c in COUNTERS.items()}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and %s/bin): the port's CUDA "
        "kernels are built from source at first use on the card"
        % cuda_home)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of the shared headers (``csrc/*.cuh``) and of the flags."""
    digest = hashlib.sha256((CSRC_DIR / ("%s.cu" % name)).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:12]))


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile each named ``csrc/<name>.cu`` that has no current build,
    all at once, and return name -> library path. Raises with the
    compiler's output when a build fails."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name("%s.tmp-%d" % (out.name, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / ("%s.cu" % name))]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append("nvcc failed on csrc/%s.cu (exit %d):\n%s"
                            % (name, proc.returncode, output))
            continue
        os.replace(tmp, todo[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
_probed_devices: set = set()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libraries[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise when a C entry point reports a CUDA error code."""
    if code != 0:
        fn = getattr(lib, "%s_error_string" % prefix)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError("%s: CUDA error %d (%s)"
                           % (prefix, code, fn(code).decode()))


# -- the probe kernel (K7) ----------------------------------------------------

PROBE_LAUNCHES = launch_counter("probe_add_one")
_probe_fn = None


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the probe kernel."""
    return x + 1.0


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` over float32: the probe kernel on a CUDA tensor, its
    plain version on a CPU tensor."""
    global _probe_fn
    if x.device.type == "cpu":
        return add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError("probe_add_one: tensor on %s" % x.device)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe_add_one takes a contiguous float32 tensor, "
                         "got %s (contiguous=%s)"
                         % (x.dtype, x.is_contiguous()))
    if _probe_fn is None:
        lib = load_library("probe")
        fn = lib.paddle_probe_add_one
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _probe_fn = (lib, fn)
    lib, fn = _probe_fn
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        check_launch(lib, "paddle_probe",
                     fn(x.data_ptr(), y.data_ptr(), x.numel(), stream))
    PROBE_LAUNCHES.inc()
    return y


def forget_probes() -> None:
    """Forget which devices ran the probe, so that the next
    ``ensure_kernels`` on each launches it again. Built libraries stay
    loaded. ``chip_smoke.py`` uses it to count the probe on the serving
    path itself."""
    with _lock:
        _probed_devices.clear()


def ensure_kernels(device: torch.device) -> None:
    """Build every kernel source (in parallel) and run the probe once on
    ``device``; raise if either fails. Memoized per device."""
    if device.type != "cuda":
        raise ValueError("ensure_kernels: %s is not a CUDA device" % device)
    index = torch.device(device).index or 0
    with _lock:
        if index in _probed_devices:
            return
    build(SOURCES)
    x = torch.zeros((8, 128), dtype=torch.float32,
                    device=torch.device("cuda", index))
    y = probe_add_one(x)
    torch.cuda.synchronize(x.device)
    if not bool((y == 1.0).all()):
        raise RuntimeError("the probe kernel ran on %s but computed wrong "
                           "values" % x.device)
    with _lock:
        _probed_devices.add(index)
