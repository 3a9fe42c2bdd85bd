"""The generic form's state ring (``csrc/rollout_generic.cuh``).

A rollout's group of G lanes rolls chunks of G steps, keeping each step's
x_t and u_t in a ring of G + 1 slots of x (run up and down in turn) and G
of u in shared memory; after each chunk lane j of the group computes the
stage cost of the chunk's step j, and after the last chunk the next free
lane (lane 0 where the chunk is whole) the final cost, so the costs run
beside each other instead of on lane 0 in every step. These tests hold,
without a card:

- the C side's shared bytes (``generic_smem_bytes``, compiled for the
  host from the header) against ``ops/rollout.py``'s mirror at every 1 <=
  n, m <= 48, both dtypes and every G;
- the slot stride's padding, which spreads the cost phase's reads of a
  warp (lane j of every group at slot j) over distinct banks;
- the chunk map at any T: each step reading the slot the last one wrote,
  every step's cost once, by one lane, summed in t order, in slots that
  do not grow with T;
- the plan rule: at every dim, both dtypes and every kind, the plan
  ``rollout_plan`` picks fits the H100's threads and shared memory (the
  linear env's parameters included, 113 KB at (48, 48) in float64), and
  an overridden G either fits or is refused.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tfmpc_tpu_torch.ops import rollout

CSRC = (Path(__file__).resolve().parents[1] / "tfmpc_tpu_torch" / "ops"
        / "csrc")
DIMS = [(n, m) for n in range(1, 49) for m in range(1, 49)]
DTYPES = [(torch.float32, 4), (torch.float64, 8)]
A = 11  # the default alpha grid's size

_HOST_STANDIN = """
#pragma once
#include <math.h>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n)
#define __shared__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct HostDim3 { unsigned x, y, z; };
extern HostDim3 threadIdx, blockIdx, blockDim;
struct cudaFuncAttributes { int maxThreadsPerBlock; };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
void __syncthreads();
void __syncwarp(unsigned = 0xffffffffu);
template <class T> T __shfl_sync(unsigned, T, int, int);
long long clock64();
size_t __cvta_generic_to_shared(const void*);
float __int_as_float(int);
double __longlong_as_double(long long);
cudaError_t cudaGetLastError();
const char* cudaGetErrorString(cudaError_t);
"""

_HOST_ENTRY = """
#include "rollout_generic.cuh"
extern "C" long long generic_bytes(int itemsize, int n, int m, int groups,
                                   int spb, int depth, int param_elems,
                                   int rollouts) {
  return tfmpc::generic_smem_bytes(itemsize, n, m, groups, spb, depth,
                                   param_elems, rollouts);
}
extern "C" int slot_stride(int len, int rp, int groups, int itemsize) {
  return tfmpc::generic_slot_stride(len, rp, groups, itemsize);
}
"""


def _linear_params(n, m):
    """The linear step's parameter values (the largest env's)."""
    return 3 * n * n + 2 * n * m + m * m + 3 * n + m


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``rollout_generic.cuh``'s host functions compiled with g++ (the
    launches, which are not C++, dropped)."""
    import ctypes

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: the header's host functions cannot be "
                    "compiled here")
    tmp = tmp_path_factory.mktemp("generic_host")
    for name in ("rollout_generic.cuh", "rollout.cuh", "envs.cuh",
                 "common.cuh", "warp.cuh"):
        (tmp / name).write_text(re.sub(r"<<<.*?>>>", "",
                                       (CSRC / name).read_text(), flags=re.S))
    (tmp / "cuda_runtime.h").write_text(_HOST_STANDIN)
    (tmp / "entry.cpp").write_text(_HOST_ENTRY)
    so = tmp / "libgenericbytes.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(tmp), "-o", str(so), str(tmp / "entry.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.generic_bytes.restype = ctypes.c_longlong
    return lib


@pytest.mark.parametrize("dtype,item", DTYPES, ids=["f32", "f64"])
def test_generic_smem_bytes_match_the_c_side(host_lib, dtype, item):
    """The C side's shared bytes of a generic block (what
    ``tfmpc_rollout_generic_smem_bytes`` returns and the launch requires)
    equal ``rollout.generic_smem_bytes`` at every 1 <= n, m <= 48, every G
    of ``GENERIC_GROUPS``, 1 and 8 scenarios a block, one alpha and the
    default grid's 11, the linear env's parameters; so do the slot
    strides."""
    for n, m in DIMS:
        pe = _linear_params(n, m)
        for G in rollout.GENERIC_GROUPS:
            for spb in (1, 8):
                for per in (1, A):
                    assert host_lib.generic_bytes(
                        item, n, m, G, spb, 1, pe, spb * per) == \
                        rollout.generic_smem_bytes(n, m, G, spb, 1, pe,
                                                   dtype, spb * per), \
                        (n, m, G, spb, per)
            rp = 3 * 32 // G if G < 32 else 3
            assert host_lib.slot_stride(n, rp, G, item) == \
                rollout.generic_slot_stride(n, rp, G, item)


@pytest.mark.parametrize("dtype,item", DTYPES, ids=["f32", "f64"])
def test_slot_stride_spreads_the_cost_reads_over_the_banks(dtype, item):
    """In the cost phase lane j of each group of a warp reads value (s0 +
    j) * stride + g of a row of the ring (g the group's column, s0 = 0 up
    the slots, 1 down; ``_chunk_map``): with the padded stride the 32
    lanes' 4-byte words fall on distinct banks in float32, and each
    half-warp's doubles on distinct bank pairs in float64 (a wavefront
    serves 128 bytes); the padding is below one wavefront's values over
    G."""
    wave = 128 // item
    for G in rollout.GENERIC_GROUPS:
        lanes = np.arange(32)
        g, j = lanes // G, lanes % G   # group, slot: lane g * G + j
        for warps in range(1, 33):
            rp = warps * 32 // G       # the block's columns, whole warps
            for length in range(1, 49):
                stride = rollout.generic_slot_stride(length, rp, G, item)
                assert 0 <= stride - length * rp <= max(1, wave // G)
                for s0 in (0, 1):
                    value = (s0 + j) * stride + g
                    per = 32 if item == 4 else 16  # lanes a wavefront
                    for w0 in range(0, 32, per):
                        banks = value[w0:w0 + per] % per
                        assert len(set(banks.tolist())) == per, \
                            (G, rp, length, s0)


def _chunk_map(T, G):
    """The kernel's chunk map: (step, lane, x slot, u slot) of each stage
    cost in the order the group sums them, the x slots each step reads
    and writes, and (lane, x slot) of the final cost. Chunk k runs up the
    x slots (0 to G) when k is even, down (G to 0) when it is odd."""
    costs, moves, final = [], [], None
    for k, t0 in enumerate(range(0, T, G)):
        steps = min(G, T - t0)
        x0, d = (G, -1) if k % 2 else (0, 1)
        moves += [(x0 + d * j, x0 + d * (j + 1)) for j in range(steps)]
        costs += [(t0 + j, j, x0 + d * j, j) for j in range(steps)]
        if t0 + steps == T:
            final = (0 if steps == G else steps, x0 + d * steps)
    return costs, moves, final


@pytest.mark.parametrize("T", [1, 7, 31, 32, 33, 100, 500, 5000])
def test_cost_ring_does_not_grow_with_T(T):
    """At any T and every G: each step reads x_t from the slot the step
    before wrote (x_0 from slot 0, where it is staged); each step's stage
    cost is taken once, by one lane, from its own step's x and u, and
    summed in t order; a chunk's costs read distinct consecutive x slots
    (the padded stride's bank rule); the final cost by one lane from x_T;
    the slots stay below G + 1 (x) and G (u) whatever T, as the shared
    bytes, which do not take T, assume; and the final cost's lane has no
    stage cost of its own in that chunk unless the chunk is whole."""
    for G in rollout.GENERIC_GROUPS:
        costs, moves, (f_lane, f_slot) = _chunk_map(T, G)
        reads = [r for r, _ in moves]
        writes = [w for _, w in moves]
        assert reads[0] == 0 and reads[1:] == writes[:-1] and \
            f_slot == writes[-1]
        assert [c[0] for c in costs] == list(range(T))
        assert all(lane == t % G and us == t % G and xs == reads[t]
                   for t, lane, xs, us in costs)
        for t0 in range(0, T, G):
            chunk = sorted(c[2] for c in costs[t0:t0 + G])
            assert chunk == list(range(chunk[0], chunk[0] + len(chunk)))
        assert 0 <= min(reads + writes) and max(reads + writes) <= G
        last = [c for c in costs if c[0] >= (T - 1) // G * G]
        assert f_lane not in [c[1] for c in last] or len(last) == G


@pytest.mark.parametrize("dtype,item", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["costs", "alpha", "traj"])
def test_generic_plan_fits_at_every_dim_and_group(kernel, dtype, item):
    """At every 1 <= n, m <= 48 with the linear env's parameters: the plan
    ``rollout_plan`` picks for the linear and the other envs' rows fits a
    block's threads and the shared memory (its bytes are
    ``generic_smem_bytes``'), G lowered from the table's only where the
    table's G does not fit one scenario a block; each G of
    ``GENERIC_GROUPS`` given as an override either fits or is refused."""
    per = A if kernel in rollout.EVERY_ALPHA else 1
    for n, m in DIMS:
        pe = _linear_params(n, m)
        for env_id in (3, 1):  # the linear rows, the other envs'
            if rollout.unrolled_dims(env_id, n, m):
                continue
            plan = rollout.rollout_plan(kernel, env_id, n, m, 4096, A,
                                        dtype, pe)
            G = rollout.generic_row(kernel, env_id, n, m)[0]
            assert plan.generic and plan.groups <= G
            assert plan.smem_bytes == rollout.generic_smem_bytes(
                n, m, plan.groups, plan.scenarios, plan.depth, pe, dtype,
                plan.scenarios * per)
            assert plan.smem_bytes <= rollout.SMEM_LIMIT
            assert plan.threads(per) <= rollout.TILE_MAX_THREADS
            if plan.groups < G:
                assert rollout.generic_smem_bytes(
                    n, m, 2 * plan.groups, 1, plan.depth, pe, dtype, per) \
                    > rollout.SMEM_LIMIT
        for G in rollout.GENERIC_GROUPS:
            try:
                p = rollout._generic_plan(kernel, 3, n, m, 4096, A, dtype,
                                          pe, G, None, None,
                                          rollout.TILE_MAX_THREADS)
            except ValueError:
                assert rollout.generic_smem_bytes(
                    n, m, G, 1, 1, pe, dtype, per) > rollout.SMEM_LIMIT \
                    or -(-per * G // 32) * 32 + 32 > rollout.TILE_MAX_THREADS
                continue
            assert p.groups == G and p.smem_bytes <= rollout.SMEM_LIMIT
            assert p.threads(per) <= rollout.TILE_MAX_THREADS
