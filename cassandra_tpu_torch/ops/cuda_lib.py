"""Build and load the port's CUDA kernels (csrc/*.cu).

The kernels are plain C entry points compiled by nvcc for sm_90a into
one shared library, loaded with ctypes. The library is built at first
use into `cassandra_tpu_torch/build/` (listed in .gitignore): one nvcc
per source, all started together, then one link. A stamp of the
sources' hash and the nvcc version decides whether a cached library is
reused.

Each kernel wrapper counts its launches in `LAUNCHES` (one per call
that launches the kernel, never for a call that runs the plain PyTorch
version), so a run can show that its main path went through the
kernels: `reset_launches()` before, `launches()` after.
`launch_sizes()` splits each count by the launch's size (the padded
round N for K1-K3, K6 and K7, the segment's cells for K4 and K5, the
keys for K9, the matrix rows for K10, the (shards, N) pair for K8), so
a check can cover every shape the path launched. The round sort (K1,
K8's sort, and K6's and K7's) also reports the passes it ran, which
only the card knows: the wrapper hands `count_launch` the sort's device
int32[1], copied to pinned host memory behind the sort, and the count
is read once that copy has completed, never in the submit: `passes()`
sums them per kernel since the reset, `last_sort()` gives the last
call's (both wait for the sorts they report on).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("scan.cu", "sort.cu", "reconcile.cu", "compact.cu", "meta.cu",
           "lzscan.cu", "planes.cu", "scanmask.cu", "ann.cu", "mesh.cu",
           "events.cu")
HEADERS = ("common.cuh",)
LIB = os.path.join(BUILD_DIR, "libctpu_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

KERNELS = ("merge.sort_perm", "merge.reconcile", "write.compact_gather",
           "write.meta_block", "write.segment_scan",
           "merge.plane_fast", "merge.plane_v2", "scan.mask", "scan.fold",
           "index.ann", "mesh.sharded_step")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
LAUNCH_SIZES: dict[str, dict[int, int]] = {k: {} for k in KERNELS}
PASSES: dict[str, int] = dict.fromkeys(KERNELS, 0)
# per kernel, (pinned host int32[1], CUDA event) of the sorts whose
# passes are not yet folded into PASSES; beyond PENDING_CAP the oldest
# is waited for, so an unread backlog cannot grow without bound
PENDING_CAP = 1024
_PENDING: dict[str, list] = {k: [] for k in KERNELS}
_LAST_SORT: dict[str, tuple] = {}
# bumped by reset_launches: a fold that took its sorts before a reset
# and reads them after it adds nothing to the new counts
_EPOCH = [0]
_count_lock = threading.Lock()
# the copies between host and card at the port's transfer points
# (ops/merge.py host_to_device and device_to_host, ops/device_write.py
# _pull): direction -> [copies, bytes]
TRANSFERS: dict[str, list] = {"h2d": [0, 0], "d2h": [0, 0]}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


def count_launch(name: str, size, passes=None) -> None:
    """One launch of kernel `name` at `size`. A round sort also passes
    its device int32[1] of the passes it ran: it is copied to the host
    behind the sort on the current stream, and read later."""
    rec = None
    if passes is not None:
        import torch
        host = passes.to("cpu", non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(passes.device))
        rec = (host, ev)
    with _count_lock:
        LAUNCHES[name] += 1
        sizes = LAUNCH_SIZES[name]
        sizes[size] = sizes.get(size, 0) + 1
        if rec is not None:
            _PENDING[name].append(rec)
            _LAST_SORT[name] = rec
    if rec is not None:
        _fold(wait=False)


def _fold(wait: bool) -> None:
    """Add the passes of the pending sorts whose copies have completed
    (all of them, waiting, when `wait`; else the oldest beyond
    PENDING_CAP are waited for) into PASSES."""
    with _count_lock:
        epoch = _EPOCH[0]
        todo = {}
        for name, recs in _PENDING.items():
            n = len(recs) if wait else max(0, len(recs) - PENDING_CAP)
            while n < len(recs) and recs[n][1].query():
                n += 1
            if n:
                todo[name] = recs[:n]
                del recs[:n]
    done = {name: sum(_read(rec) for rec in recs)
            for name, recs in todo.items()}
    with _count_lock:
        if _EPOCH[0] != epoch:
            return
        for name, p in done.items():
            PASSES[name] += p


def _read(rec) -> int:
    host, ev = rec
    ev.synchronize()
    return int(host[0])


def count_transfer(direction: str, nbytes: int) -> None:
    """One copy of `nbytes` between host and card ("h2d" or "d2h")."""
    with _count_lock:
        rec = TRANSFERS[direction]
        rec[0] += 1
        rec[1] += int(nbytes)


def transfers() -> dict[str, dict[str, int]]:
    """{direction: {"copies", "bytes"}} since the last reset."""
    with _count_lock:
        return {k: {"copies": v[0], "bytes": v[1]}
                for k, v in TRANSFERS.items()}


def reset_transfers() -> None:
    with _count_lock:
        for rec in TRANSFERS.values():
            rec[0] = rec[1] = 0


def reset_launches() -> None:
    with _count_lock:
        _EPOCH[0] += 1
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            PASSES[k] = 0
            LAUNCH_SIZES[k].clear()
            _PENDING[k].clear()
        _LAST_SORT.clear()


def passes() -> dict[str, int]:
    """{kernel: sort passes run} since the last reset (waits for the
    sorts still running)."""
    _fold(wait=True)
    with _count_lock:
        return dict(PASSES)


def last_sort(name: str) -> dict:
    """The last round sort of `name`: {"passes"} (waits for it)."""
    with _count_lock:
        rec = _LAST_SORT.get(name)
    return {"passes": 0 if rec is None else _read(rec)}


def launches() -> dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def launch_sizes() -> dict[str, dict[int, int]]:
    """{kernel: {size: launches}} since the last reset."""
    with _count_lock:
        return {k: dict(v) for k, v in LAUNCH_SIZES.items()}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return p


def _stamp(nvcc: str) -> str:
    h = hashlib.sha256()
    for f in SOURCES + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    ver = subprocess.run([nvcc, "--version"], check=True,
                         capture_output=True, text=True).stdout
    h.update(ver.encode() + " ".join(ARCH_FLAGS).encode())
    return h.hexdigest()


def build(force: bool = False) -> str:
    """Compile the sources (in parallel) and link the library unless a
    library with the same stamp exists. Returns the compilers' output
    (`-Xptxas -v`: registers, shared memory and spills per kernel);
    raises with that output when a step fails."""
    global BUILD_LOG
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    stamp = _stamp(nvcc)
    stamp_path = LIB + ".stamp"
    if not force and os.path.exists(LIB) and os.path.exists(stamp_path):
        with open(stamp_path) as f:
            if f.read().strip() == stamp:
                return BUILD_LOG
    pid = os.getpid()
    procs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{src}.{pid}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
               "-Xcompiler", "-fPIC", "-I", CSRC, "-c",
               os.path.join(CSRC, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"--- {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    objs = [obj for _src, obj, _p in procs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = f"{LIB}.tmp.{pid}"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, LIB)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(stamp_path + f".{pid}", "w") as f:
        f.write(stamp)
    os.replace(stamp_path + f".{pid}", stamp_path)
    BUILD_LOG = log
    return log


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_U = ctypes.c_uint32
_Q = ctypes.c_uint64

_SIGNATURES = {
    "ctpu_sort_scratch_bytes": (_L, [_I, _I]),
    "ctpu_sort_perm": (_I, [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P]),
    "ctpu_reconcile_scratch_bytes": (_L, [_I]),
    "ctpu_reconcile": (_I, [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _P, _I, _P, _P, _P]),
    "ctpu_compact_scratch_bytes": (_L, [_I]),
    "ctpu_compact_gather": (_I, [_P, _P, _I, _I] + [_P] * 8
                            + [_P, _P] + [_P] * 8 + [_P, _P]),
    "ctpu_meta_scratch_bytes": (_L, [_I]),
    "ctpu_meta_block": (_I, [_P] * 7 + [_I, _I, _P, _P, _P, _P]),
    "ctpu_lzscan_scratch_bytes": (_L, [_L, _L]),
    "ctpu_segment_scan": (_I, [_P, _I, _P, _I, _I] + [_P] * 8),
    "ctpu_planes_scratch_bytes": (_L, [_I, _I]),
    "ctpu_plane_fast": (_I, [_P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P]),
    "ctpu_plane_v2": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _U, _P, _U, _I,
                           _P, _P, _P, _P, _P]),
    "ctpu_scan_mask": (_I, [_P, _I, _I, _Q, _P, _I, _P, _P]),
    "ctpu_scan_fold_scratch_bytes": (_L, [_I]),
    "ctpu_scan_fold": (_I, [_P, _P, _I, _P, _P, _P]),
    "ctpu_ann_k_fused": (_I, []),
    "ctpu_ann_fused_scratch_bytes": (_L, [_I, _I]),
    "ctpu_ann_topk": (_I, [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P]),
    "ctpu_ann_select_scratch_bytes": (_L, [_I, _I]),
    "ctpu_ann_topk_select": (_I, [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                                  _P]),
    "ctpu_event_create": (_P, []),
    "ctpu_event_record": (_I, [_P, _P]),
    "ctpu_events_ms": (_I, [_P, _P, _I, _I, _P]),
    "ctpu_mesh_scratch_bytes": (_L, [_I, _I, _I]),
    "ctpu_mesh_step": (_I, [_P, _I] + [_P] * 9 + [_I, _I, _I, _I]
                       + [_P] * 7),
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            try:
                so = ctypes.CDLL(LIB)
            except OSError as e:
                # not an I/O error of the caller's data: callers that
                # handle OSError (a corrupt sstable) must not take it
                raise RuntimeError(f"cannot load {LIB}: {e}") from e
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.restype = res
                fn.argtypes = args
            _lib = so
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def is_cuda(t) -> bool:
    """True when tensor `t` lives on a CUDA device (launch the kernel),
    False on the CPU (run the plain version); raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device!s}")


_raw_stream = None


def raw_stream(dev) -> int:
    """The raw handle of `dev`'s current CUDA stream."""
    global _raw_stream
    if _raw_stream is None:
        import torch
        _raw_stream = getattr(
            torch._C, "_cuda_getCurrentRawStream",
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(dev.index)


def stream_of(t) -> int:
    return raw_stream(t.device)


_get_device = None


def on_device(dev):
    """The context for launching on `dev`: none when `dev` is already
    the current device (the usual case; entering torch.cuda.device
    costs more than a launch)."""
    global _get_device
    if _get_device is None:
        import torch
        _get_device = getattr(torch._C, "_cuda_getDevice",
                              torch.cuda.current_device)
    if dev.index is None or dev.index == _get_device():
        return contextlib.nullcontext()
    import torch
    return torch.cuda.device(dev)


# Timing events of the profiling registry (service/profiling.py), as raw
# handles of csrc/events.cu: one ctypes call to create or record one
# (`ctpu_event_record`) and one to read a batch of pairs, where a
# torch.cuda.Event costs several times that.


def event_create(dev) -> int:
    """A new timing event on `dev`."""
    with on_device(dev):
        ev = lib().ctpu_event_create()
    if not ev:
        raise RuntimeError("cudaEventCreate failed")
    return ev


def events_ms(pairs: list, wait: bool = False) -> list:
    """The milliseconds of [(start, end)] event pairs, in order, up to
    the first pair still pending (`wait`: wait for the first pair's end
    first)."""
    n = len(pairs)
    starts = (ctypes.c_void_p * n)(*[p[0] for p in pairs])
    ends = (ctypes.c_void_p * n)(*[p[1] for p in pairs])
    ms = (ctypes.c_float * n)()
    done = lib().ctpu_events_ms(starts, ends, n, int(wait), ms)
    if done < 0:
        raise RuntimeError(f"cudaEventElapsedTime failed: cudaError "
                           f"{-1 - done}")
    return ms[:done]
