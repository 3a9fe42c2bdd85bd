"""Build and load the CUDA kernels of ``ops/csrc``.

Every ``.cu`` under ``csrc/`` is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs at the first launch, never at import, and is cached in
``ops/_build/`` under a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing is downloaded and no
PyTorch header is compiled (such a build takes minutes instead of seconds).

A user env's generated step functor (``ops/env_codegen.py``) is compiled
apart, one library a generated source (``user_library``): one ``nvcc`` of
``csrc/rollout_user.cuh`` with the source as ``user_step.cuh``, cached in
``ops/_build/user/`` under a hash of the source, the headers and the flags.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
USER_DIR = BUILD_DIR / "user"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C entry points of csrc/*.cu. Every pointer, host or device, and the stream
# are c_void_p: a bare Python int would be passed as a 32-bit int.
_SIGNATURES = {
    # dtype, n, m, T, B, fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT,
    # K, k, dV1, dV2, fail, then the lane plan (lanes a scenario, scenarios
    # a block, shared bytes) and the stream
    "tfmpc_riccati_backward": [_I] * 5 + [_P] * 15 + [_I, _I, _LL, _P],
    # dtype, n, m, T, B, newton_iters, fx, fu, lx, lu, lxx, luu, lux, mu,
    # ubar, lo, hi, VT, vT, K, k, dV1, dV2, fail, plan, stream
    "tfmpc_riccati_backward_boxqp": [_I] * 6 + [_P] * 18
    + [_I, _I, _LL, _P],
    # as tfmpc_riccati_backward, with fxx, fux, fuu after mu
    "tfmpc_riccati_backward_ddp": [_I] * 5 + [_P] * 18 + [_I, _I, _LL, _P],
    # as tfmpc_riccati_backward_boxqp, with fxx, fux, fuu after hi
    "tfmpc_riccati_backward_ddp_boxqp": [_I] * 6 + [_P] * 21
    + [_I, _I, _LL, _P],
    # K7 (riccati_mid.cu), the solver's [B, T, ...] layout: as
    # tfmpc_riccati_backward and tfmpc_riccati_backward_boxqp up to fail;
    # then the plan (warps, scenarios per block, stage_l, shared
    # bytes) and the stream
    "tfmpc_riccati_backward_mid": [_I] * 5 + [_P] * 15 + [_I] * 3
    + [_LL, _P],
    "tfmpc_riccati_backward_mid_boxqp": [_I] * 6 + [_P] * 18 + [_I] * 3
    + [_LL, _P],
    # K7's full-DDP variant (riccati_mid_ddp.cu): as the iLQR one, with
    # fxx, fux, fuu after mu
    "tfmpc_riccati_backward_mid_ddp": [_I] * 5 + [_P] * 18 + [_I] * 3
    + [_LL, _P],
    # K4 and K6b at small dims (riccati_small.cu, riccati_small_ddp.cu):
    # as K7's boxQP entries up to fail, then the plan (lanes a scenario,
    # scenarios a block, Hessians staged, shared bytes) and the stream
    "tfmpc_riccati_backward_small_boxqp": [_I] * 6 + [_P] * 18
    + [_I] * 3 + [_LL, _P],
    "tfmpc_riccati_backward_small_ddp_boxqp": [_I] * 6 + [_P] * 21
    + [_I] * 3 + [_LL, _P],
    # K1 and K6a at small dims (riccati_small_ilqr.cu,
    # riccati_small_ddp_ilqr.cu): as K7's iLQR and DDP entries up to fail,
    # then the small-dims plan and the stream
    "tfmpc_riccati_backward_small": [_I] * 5 + [_P] * 15
    + [_I] * 3 + [_LL, _P],
    "tfmpc_riccati_backward_small_ddp": [_I] * 5 + [_P] * 18
    + [_I] * 3 + [_LL, _P],
    # P1 (row_matmul.cu): dtype, d, B, A, M, C, tile rows, tile columns,
    # stream
    "tfmpc_row_matmul": [_I] * 3 + [_P] * 3 + [_I, _I, _P],
    # K2: dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi (null:
    # unbounded), alphas (host f64), A, params (host void*[]), n_params,
    # int_params (host int[]), n_int, J, then the plan (lanes a rollout,
    # scenarios a block, steps staged ahead, shared bytes) and the stream
    "tfmpc_linesearch_costs": [_I] * 6 + [_P] * 7 + [_I, _P, _I, _P, _I]
    + [_P, _I, _I, _I, _LL, _P],
    # K5: as K2 up to J, then X, U, the plan and the stream
    "tfmpc_linesearch_costs_traj": [_I] * 6 + [_P] * 7
    + [_I, _P, _I, _P, _I] + [_P] * 3 + [_I, _I, _I, _LL, _P],
    # K3: dtype, env, n, m, T, B, alpha, xbar, ubar, K, k, lo, hi, params,
    # n_params, int_params, n_int, X, U, J, the plan as K2's, stream
    "tfmpc_rollout_alpha": [_I] * 6 + [_P] * 8 + [_I, _P, _I]
    + [_P] * 3 + [_I, _I, _I, _LL, _P],
    # K8 (rollout_derivs.cu): as tfmpc_rollout_alpha, with lin (host
    # void*[7]: fx, fu, lx, lu, lxx, luu, lux) after J
    "tfmpc_rollout_alpha_derivs": [_I] * 6 + [_P] * 8 + [_I, _P, _I]
    + [_P] * 4 + [_I, _I, _I, _LL, _P],
    # K2/K3/K5/K8 in the generic form (rollout_generic.cu): kind, dtype,
    # env, n, m, T, B, xbar, ubar, K, k, lo, hi, alphas (host f64 or null),
    # A, alpha (device or null), params, n_params, int_params, n_int, J, X,
    # U (null for K2), lin (K8's, as tfmpc_rollout_alpha_derivs'; else
    # null), the plan as K2's and the stream
    "tfmpc_rollout_generic": [_I] * 7 + [_P] * 7 + [_I, _P, _P, _I, _P, _I]
    + [_P] * 4 + [_I, _I, _I, _LL, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _nvcc() -> str:
    candidates = [os.environ.get("NVCC"), shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtfmpc_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds, log_prefix: Path):
    """Run the commands in parallel, each writing its output to a file
    beside the build (no pipe to fill); raise naming the first that failed.
    Returns their combined output, in command order, then one line a
    command, ``nvcc wall s <its last argument>: <seconds>``."""
    paths = [log_prefix.with_name(f"{log_prefix.name}.{i}.out")
             for i in range(len(cmds))]
    procs = []
    try:
        start = time.perf_counter()
        for cmd, path in zip(cmds, paths):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT))
        walls = [None] * len(procs)
        while None in walls:
            for i, proc in enumerate(procs):
                if walls[i] is None and proc.poll() is not None:
                    walls[i] = time.perf_counter() - start
            time.sleep(0.05)
        logs = [path.read_text() for path in paths]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}: "
                    f"{' '.join(cmd)}\n{log}"
                )
        return "".join(logs) + "".join(
            f"nvcc wall s {Path(cmd[-1]).name}: {wall:.1f}\n"
            for cmd, wall in zip(cmds, walls))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in paths:
            path.unlink(missing_ok=True)


def _compile(so: Path) -> None:
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    nvcc = _nvcc()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources, objs)],
                       BUILD_DIR / f"{tag}.compile")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)]], BUILD_DIR / f"{tag}.link")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the sources changed."""
    so = library_path()
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tfmpc_error_string.argtypes = [ctypes.c_int]
    lib.tfmpc_error_string.restype = ctypes.c_char_p
    # dtype, n, m, scenarios per block, stage_l
    lib.tfmpc_riccati_mid_smem_bytes.argtypes = [_I] * 5
    lib.tfmpc_riccati_mid_smem_bytes.restype = ctypes.c_longlong
    # dtype, box, ddp, n, m, scenarios per block, Hessians staged
    lib.tfmpc_riccati_small_smem_bytes.argtypes = [_I] * 7
    lib.tfmpc_riccati_small_smem_bytes.restype = ctypes.c_longlong
    # dtype, n, m, the plan (lanes a scenario, scenarios a block, Hessians
    # staged, shared bytes): the blocks of K6a's plan an SM holds
    lib.tfmpc_riccati_small_ddp_ilqr_blocks_per_sm.argtypes = [_I] * 6 \
        + [_LL]
    lib.tfmpc_riccati_small_ddp_ilqr_blocks_per_sm.restype = ctypes.c_int
    # n, m
    lib.tfmpc_riccati_small_groups.argtypes = [_I] * 2
    lib.tfmpc_riccati_small_groups.restype = ctypes.c_int
    # box, ddp, dtype, n, m, scenarios per block
    lib.tfmpc_riccati_lane_smem_bytes.argtypes = [_I] * 6
    lib.tfmpc_riccati_lane_smem_bytes.restype = ctypes.c_longlong
    # dtype, n, m, lanes a rollout, scenarios a block, depth, param values
    lib.tfmpc_rollout_smem_bytes.argtypes = [_I] * 7
    lib.tfmpc_rollout_smem_bytes.restype = ctypes.c_longlong
    # kind (ops/rollout.py KIND_CODES), dtype, env, n, m, lanes a rollout,
    # params, n_params, int_params, n_int
    lib.tfmpc_rollout_max_threads.argtypes = [_I] * 6 + [_P, _I, _P, _I]
    lib.tfmpc_rollout_max_threads.restype = ctypes.c_int
    # the generic form's: dtype, n, m, lanes a rollout, scenarios a block,
    # depth, param values, rollouts a block
    lib.tfmpc_rollout_generic_smem_bytes.argtypes = [_I] * 8
    lib.tfmpc_rollout_generic_smem_bytes.restype = ctypes.c_longlong
    # kind, dtype, env, n, m, params, n_params, int_params, n_int
    lib.tfmpc_rollout_generic_max_threads.argtypes = [_I] * 5 + [_P, _I, _P,
                                                                 _I]
    lib.tfmpc_rollout_generic_max_threads.restype = ctypes.c_int
    return lib


# the C entries of a user library (csrc/rollout_user.cuh)
_USER_SIGNATURES = {
    # tfmpc_rollout_generic's arguments without env
    "tfmpc_rollout_user": [_I] * 6 + [_P] * 7 + [_I, _P, _P, _I, _P, _I]
    + [_P] * 4 + [_I, _I, _I, _LL, _P],
}


def user_library_path(source: str) -> Path:
    """Where the user library of the generated functor ``source`` lives:
    keyed by the source, the ``csrc`` headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return USER_DIR / h.hexdigest()[:16] / "libtfmpc_user.so"


def build_user_libraries(sources) -> str:
    """Build the user libraries of the generated functors ``sources`` that
    are not built yet, one nvcc each, all started together. Returns nvcc's
    output (ptxas lines included), then one ``nvcc wall s`` line a build;
    raises with nvcc's text if one fails."""
    todo = {}
    for source in sources:
        so = user_library_path(source)
        if not so.exists():
            todo[so] = source
    if not todo:
        return ""
    nvcc = _nvcc()
    cmds, tmps = [], []
    for so, source in todo.items():
        so.parent.mkdir(parents=True, exist_ok=True)
        (so.parent / "user_step.cuh").write_text(
            "#pragma once\n" + source)
        cu = so.parent / f"rollout_user_{so.parent.name}.cu"
        cu.write_text('#include "rollout_user.cuh"\n')
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        tmps.append(tmp)
        cmds.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-I",
                     str(so.parent), "-shared", "-o", str(tmp), str(cu)])
    try:
        log = _run_all(cmds, USER_DIR / f"build.{os.getpid()}")
    except BaseException:
        for tmp in tmps:
            tmp.unlink(missing_ok=True)
        raise
    for so, tmp in zip(todo, tmps):
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    return log


@functools.lru_cache(maxsize=None)
def user_library(source: str) -> ctypes.CDLL:
    """The loaded library of K2, K3 and K5 on the generated step functor
    ``source`` (``csrc/rollout_user.cuh``), built at its first use."""
    build_user_libraries([source])
    lib = ctypes.CDLL(str(user_library_path(source)))
    for name, argtypes in _USER_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # kind, dtype, n, m, params, n_params, int_params, n_int
    lib.tfmpc_rollout_user_max_threads.argtypes = [_I] * 4 + [_P, _I, _P,
                                                              _I]
    lib.tfmpc_rollout_user_max_threads.restype = ctypes.c_int
    # as tfmpc_rollout_generic_smem_bytes
    lib.tfmpc_rollout_user_smem_bytes.argtypes = [_I] * 8
    lib.tfmpc_rollout_user_smem_bytes.restype = ctypes.c_longlong
    lib.tfmpc_rollout_user_error_string.argtypes = [ctypes.c_int]
    lib.tfmpc_rollout_user_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str, lib: ctypes.CDLL | None = None) -> None:
    """Raise if a C entry returned a non-zero CUDA error code (``lib``: a
    user library's entry; by default the kernel library's)."""
    if rc != 0:
        msg = (library().tfmpc_error_string(rc) if lib is None
               else lib.tfmpc_rollout_user_error_string(rc)).decode()
        raise RuntimeError(f"{what}: kernel launch failed ({rc}: {msg})")


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, as the kernels' launch stream."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
