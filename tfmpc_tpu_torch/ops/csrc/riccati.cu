// K1: the whole batched, regularized Riccati backward pass of iLQR in one
// kernel.
//
// Replaces: tfmpc_tpu/ops/riccati_pallas.py:_riccati_pallas_raw (adapter
// riccati_backward_pallas; body _kernel / _riccati_step_math /
// _chol_unrolled / _chol_solve_unrolled), unconstrained variant.
//
// What bounds it on this card: the T steps of one scenario form a serial
// chain (V_t depends on V_{t+1}), so the kernel is latency-bound, not
// bandwidth- or FLOP-bound. At n = m = 2 a step reads 22 scalars and writes
// 6 per scenario (B=4096, T=100, f32: ~11 MB in all, a few microseconds of
// HBM time at 3.35 TB/s) and does ~150 FLOPs of dependent arithmetic.
//
// What the design does about it: one thread owns one scenario and keeps the
// value function (V, v), the accumulators and every intermediate in
// registers for the whole chain; the dims are template parameters so all
// small-matrix loops unroll. Inputs keep the JAX kernel layout
// [T, entries, B], so the 32 threads of a warp read 32 consecutive
// addresses: every load and store is coalesced. A step's loads do not
// depend on the chain, so they are issued ahead of its arithmetic. At
// B=4096 there are only 4096 threads; blocks of 32 give 128 blocks, one per
// SM on 128 of the 132 SMs, rather than 16 blocks of 256 on 16 SMs.
//
// Arithmetic mirrors _riccati_step_math op for op: Q blocks from V and the
// regularized V + mu I, an unrolled Cholesky of the regularized Quu with a
// per-lane fail flag (pivot <= 0 or non-finite; sqrt clamped at 1e-30),
// k and K by two triangular solves, dV1/dV2 from the UNregularized Q terms,
// and V' computed on its upper triangle and mirrored.
#include "common.cuh"

namespace tfmpc {
namespace {

template <typename S, int N, int M>
__global__ void riccati_backward_kernel(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ mu_in,
    const S* __restrict__ VT, const S* __restrict__ vT,
    S* __restrict__ K_out, S* __restrict__ k_out, S* __restrict__ dV1_out,
    S* __restrict__ dV2_out, S* __restrict__ fail_out, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  S V[N][N], v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) V[i][j] = VT[(int64_t)(i * N + j) * B + b];
    v[i] = vT[(int64_t)i * B + b];
  }
  const S mu = mu_in[b];
  S dV1 = 0, dV2 = 0;
  bool fail = false;

  for (int t = T - 1; t >= 0; --t) {
    S Fx[N][N], Fu[N][M], Lx[N], Lu[M], Lxx[N][N], Luu[M][M], Lux[M][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Fx[i][j] = fx[at(t, i * N + j, N * N, b, B)];
        Lxx[i][j] = lxx[at(t, i * N + j, N * N, b, B)];
      }
#pragma unroll
      for (int a = 0; a < M; ++a) Fu[i][a] = fu[at(t, i * M + a, N * M, b, B)];
      Lx[i] = lx[at(t, i, N, b, B)];
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      Lu[a] = lu[at(t, a, M, b, B)];
#pragma unroll
      for (int c = 0; c < M; ++c) Luu[a][c] = luu[at(t, a * M + c, M * M, b, B)];
#pragma unroll
      for (int i = 0; i < N; ++i) Lux[a][i] = lux[at(t, a * N + i, M * N, b, B)];
    }

    S VR[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) VR[i][j] = V[i][j] + (i == j ? mu : S(0));

    // Q_x = l_x + f_x^T v ; Q_u = l_u + f_u^T v
    S Qx[N], Qu[M];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) acc += Fx[p][i] * v[p];
      Qx[i] = Lx[i] + acc;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) acc += Fu[p][a] * v[p];
      Qu[a] = Lu[a] + acc;
    }

    // W = V f_x, Wu = V f_u, WRu = (V + mu I) f_u, WRx = (V + mu I) f_x
    S W[N][N], Wu[N][M], WRu[N][M], WRx[N][N];
#pragma unroll
    for (int p = 0; p < N; ++p) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        S w = 0, wr = 0;
#pragma unroll
        for (int q = 0; q < N; ++q) {
          w += V[p][q] * Fx[q][j];
          wr += VR[p][q] * Fx[q][j];
        }
        W[p][j] = w;
        WRx[p][j] = wr;
      }
#pragma unroll
      for (int c = 0; c < M; ++c) {
        S w = 0, wr = 0;
#pragma unroll
        for (int q = 0; q < N; ++q) {
          w += V[p][q] * Fu[q][c];
          wr += VR[p][q] * Fu[q][c];
        }
        Wu[p][c] = w;
        WRu[p][c] = wr;
      }
    }

    S Qxx[N][N], Quu[M][M], Qux[M][N], QuuR[M][M], QuxR[M][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        S acc = 0;
#pragma unroll
        for (int p = 0; p < N; ++p) acc += Fx[p][i] * W[p][j];
        Qxx[i][j] = Lxx[i][j] + acc;
      }
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        S acc = 0, accR = 0;
#pragma unroll
        for (int p = 0; p < N; ++p) {
          acc += Fu[p][a] * Wu[p][c];
          accR += Fu[p][a] * WRu[p][c];
        }
        Quu[a][c] = Luu[a][c] + acc;
        QuuR[a][c] = Luu[a][c] + accR;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        S acc = 0, accR = 0;
#pragma unroll
        for (int p = 0; p < N; ++p) {
          acc += Fu[p][a] * W[p][i];
          accR += Fu[p][a] * WRx[p][i];
        }
        Qux[a][i] = Lux[a][i] + acc;
        QuxR[a][i] = Lux[a][i] + accR;
      }
    }

    // Cholesky of QuuR with the per-lane PD probe.
    S L[M][M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S acc = 0;
#pragma unroll
      for (int c = 0; c < a; ++c) acc += L[a][c] * L[a][c];
      const S s = QuuR[a][a] - acc;
      if (!(s > S(0)) || !dfinite(s)) fail = true;
      // jnp.maximum(s, 1e-30): NaN stays NaN
      const S sc = (s != s) ? s : (s > S(1e-30) ? s : S(1e-30));
      const S La = dsqrt(sc);
      L[a][a] = La;
      const S inv = S(1) / La;
#pragma unroll
      for (int r = a + 1; r < M; ++r) {
        S acc2 = 0;
#pragma unroll
        for (int c = 0; c < a; ++c) acc2 += L[r][c] * L[a][c];
        L[r][a] = (QuuR[r][a] - acc2) * inv;
      }
    }

    // k = -QuuR^-1 Qu ; column i of K = -QuuR^-1 QuxR[:, i]
    S kv[M], Kt[M][N];
#pragma unroll
    for (int col = 0; col <= N; ++col) {
      S rhs[M], y[M], xs[M];
#pragma unroll
      for (int a = 0; a < M; ++a) rhs[a] = (col == N) ? Qu[a] : QuxR[a][col];
#pragma unroll
      for (int a = 0; a < M; ++a) {
        S acc = 0;
#pragma unroll
        for (int c = 0; c < a; ++c) acc += L[a][c] * y[c];
        y[a] = (rhs[a] - acc) / L[a][a];
      }
#pragma unroll
      for (int a = M - 1; a >= 0; --a) {
        S acc = 0;
#pragma unroll
        for (int r = a + 1; r < M; ++r) acc += L[r][a] * xs[r];
        xs[a] = (y[a] - acc) / L[a][a];
      }
#pragma unroll
      for (int a = 0; a < M; ++a) {
        if (col == N) kv[a] = -xs[a];
        else Kt[a][col] = -xs[a];
      }
    }

    // Expected improvement with the unregularized Q terms.
    {
      S acc = 0;
#pragma unroll
      for (int a = 0; a < M; ++a) acc += kv[a] * Qu[a];
      dV1 = dV1 + acc;
      S acc2 = 0;
#pragma unroll
      for (int a = 0; a < M; ++a)
#pragma unroll
        for (int c = 0; c < M; ++c) acc2 += kv[a] * Quu[a][c] * kv[c];
      dV2 = dV2 + S(0.5) * acc2;
    }

    // Value update (unregularized), upper triangle mirrored.
    S Quu_k[M], Quu_K[M][N];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S acc = 0;
#pragma unroll
      for (int c = 0; c < M; ++c) acc += Quu[a][c] * kv[c];
      Quu_k[a] = acc;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        S acc2 = 0;
#pragma unroll
        for (int c = 0; c < M; ++c) acc2 += Quu[a][c] * Kt[c][j];
        Quu_K[a][j] = acc2;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i; j < N; ++j) {
        S s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
        for (int a = 0; a < M; ++a) {
          s1 += Kt[a][i] * Quu_K[a][j];
          s2 += Kt[a][i] * Qux[a][j];
          s3 += Qux[a][i] * Kt[a][j];
        }
        const S val = ((Qxx[i][j] + s1) + s2) + s3;
        V[i][j] = val;
        V[j][i] = val;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int a = 0; a < M; ++a) {
        s1 += Kt[a][i] * Quu_k[a];
        s2 += Kt[a][i] * Qu[a];
        s3 += Qux[a][i] * kv[a];
      }
      v[i] = ((Qx[i] + s1) + s2) + s3;
    }

#pragma unroll
    for (int a = 0; a < M; ++a) {
      k_out[at(t, a, M, b, B)] = kv[a];
#pragma unroll
      for (int i = 0; i < N; ++i) K_out[at(t, a * N + i, M * N, b, B)] = Kt[a][i];
    }
  }

  dV1_out[b] = dV1;
  dV2_out[b] = dV2;
  fail_out[b] = fail ? S(1) : S(0);
}

template <typename S, int N, int M>
int launch(int T, int B, const void* fx, const void* fu, const void* lx,
           const void* lu, const void* lxx, const void* luu, const void* lux,
           const void* mu, const void* VT, const void* vT, void* K, void* k,
           void* dV1, void* dV2, void* fail, int block, cudaStream_t stream) {
  riccati_backward_kernel<S, N, M>
      <<<blocks_for(B, block), block, 0, stream>>>(
          (const S*)fx, (const S*)fu, (const S*)lx, (const S*)lu,
          (const S*)lxx, (const S*)luu, (const S*)lux, (const S*)mu,
          (const S*)VT, (const S*)vT, (S*)K, (S*)k, (S*)dV1, (S*)dV2,
          (S*)fail, T, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tfmpc

extern "C" int tfmpc_riccati_backward(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int block, void* stream) {
  using namespace tfmpc;
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 2 && m == 2) {
    if (dtype == kFloat32)
      return launch<float, 2, 2>(T, B, fx, fu, lx, lu, lxx, luu, lux, mu, VT,
                                 vT, K, k, dV1, dV2, fail, block, s);
    if (dtype == kFloat64)
      return launch<double, 2, 2>(T, B, fx, fu, lx, lu, lxx, luu, lux, mu, VT,
                                  vT, K, k, dV1, dV2, fail, block, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tfmpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
