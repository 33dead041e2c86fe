// Fused last-layer gradient sketch for Hopper (sm_90a), fp32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grad_sketch/kernel.py
// (grad_sketch_units, bodies _lse_kernel and _sketch_kernel; grad_sketch
// is its U = 1 case).  Per unit u it computes
//     out[u] = (H R1)^T (E R2),  E = diag(scale) (softmax(H W) - onehot(t))
// without an (n, V) logits, probability or error tensor in device memory.
// The TPU kernel takes two passes over the vocab (logsumexp, then the
// sketch); this one takes one, with an online softmax: per vocab tile it
// moves the row's running max m, rescales the running sum s of
// exp(logit - m) and the p.R2 accumulator by exp(m_old - m), and adds
// the tile's terms.  logz = m + log(max(s, 1e-30)) and p = exp(logit -
// logz) as in the reference, padded vocab columns counting 0; then er2 =
// (p R2 - R2[t]) * scale and out[u] = sum_n hr[n]^T er2[n].  hr = H R1 and
// rvt = R2[clip(t)] come from outside, as in the reference.
//
// What bounds it on this card: operations.  The h.W product is 2 n d V
// fp32 FLOPs (plus 2 n V k2 for p.R2) against 4 d V bytes of W, ~n/2
// FLOPs per byte: far above the fp32 ridge.  TF32 and the tensor cores
// are off by contract: the reference computes the sketch in full fp32.
//
// Design (simple first; wgmma/TMA are later work):
// - the head is read as wt = W^T, contiguous (V, d) rows: the tied
//   embedding's own layout, so the logits tile is an "NT" product of two
//   row-major panels, both K-contiguous, like omp_gram.cu;
// - logits tiles are 64 x 64 fp32 SIMT GEMM tiles: BK = 16 slices of
//   both panels staged through padded shared memory, 4 x 4 register
//   accumulators per thread, fmaf in d order;
// - a block owns one 64-row tile of one unit and one contiguous split of
//   the vocab tiles (grid = splits x row tiles x units), so a single unit
//   of ~2k rows still fills the card.  Blocks never share an output: each
//   writes its split's (m, s) per row and its (rows, k2) p.R2 partial
//   (relative to its own m); a second kernel merges the splits in split
//   order, normalizes, subtracts R2[t], scales, and accumulates hr^T er2
//   over the rows in row order.  No atomics anywhere, so two launches on
//   the same inputs give the same bits.
#include <cuda_runtime.h>

#define BM 64
#define BN 64
#define BK 16
#define FR 16
#define THREADS 256
#define NEG (-1e30f)

// One BK-wide slice [k0, k0 + BK) of rows [r0, r0 + BM) of a row-major
// (rows, d) matrix, stored transposed into S (zero outside the matrix).
__device__ __forceinline__ void stage_panel(float (*S)[BM + 1],
                                            const float* __restrict__ a,
                                            int r0, int rows, int k0, int d,
                                            int tid) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
        const int e = tid + l * THREADS;
        const int r = e / BK;
        const int kk = e % BK;
        const int row = r0 + r;
        const int k = k0 + kk;
        S[kk][r] = (row < rows && k < d) ? a[(size_t)row * d + k] : 0.0f;
    }
}

// acc[i][j] = h[r0 + ty*4 + i] . wt[c0 + tx*4 + j] over the whole of d.
// Ends with a barrier, so the caller may reuse shared memory at once.
__device__ __forceinline__ void logits_tile(float acc[4][4],
                                            float (*As)[BM + 1],
                                            float (*Bs)[BM + 1],
                                            const float* __restrict__ h,
                                            const float* __restrict__ wt,
                                            int r0, int n, int c0, int V,
                                            int d, int tid, int tx, int ty) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += BK) {
        stage_panel(As, h, r0, n, k0, d, tid);
        stage_panel(Bs, wt, c0, V, k0, d, tid);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
}

// Per split: one walk over the split's vocab tiles with an online
// softmax.  For each row it keeps the running max m and the sum s of
// exp(logit - m), and er2_part[row, :] = sum over the split's vocab of
// exp(logit - m) R2[v, :], rescaled by exp(m_old - m) whenever m moves.
// The 16 lanes that share a row (tid = ty * 16 + tx, one half-warp)
// agree on m through a shuffle max, so each keeps only its share of s.
// p goes through shared memory (transposed), R2 in 64-column chunks; the
// (BM, k2) accumulator lives in dynamic shared memory, element
// (ty * 4 + i, j0 + tx * 4 + jj) owned by thread (ty, tx) throughout.
__global__ void __launch_bounds__(THREADS)
gs_partial(const float* __restrict__ h, const float* __restrict__ wt,
           const float* __restrict__ r_v, float* __restrict__ m_part,
           float* __restrict__ s_part, float* __restrict__ er2_part, int n,
           int d, int V, int k2, int tiles_per_split) {
    extern __shared__ float Es[];                 // [BM][k2]
    __shared__ float As[BK][BM + 1];
    __shared__ float Bs[BK][BM + 1];
    __shared__ float Ps[BN][BM + 1];              // p transposed: [col][row]
    __shared__ float Rs[BN][BM + 1];              // R2 chunk: [col][k2 col]
    const int split = blockIdx.x;
    const int r0 = blockIdx.y * BM;
    const int u = blockIdx.z;
    const int U = gridDim.z;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const float* hu = h + (size_t)u * n * d;
    const int n_tiles = (V + BN - 1) / BN;
    const int t0 = split * tiles_per_split;
    const int t1 = min(t0 + tiles_per_split, n_tiles);

    for (int e = tid; e < BM * k2; e += THREADS) Es[e] = 0.0f;
    __syncthreads();
    float m[4], s[4], alpha[4], acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        s[i] = 0.0f;
    }
    for (int t = t0; t < t1; ++t) {
        const int c0 = t * BN;
        logits_tile(acc, As, Bs, hu, wt, r0, n, c0, V, d, tid, tx, ty);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float tmax = NEG;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (c0 + tx * 4 + j < V) tmax = fmaxf(tmax, acc[i][j]);
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
            const float mn = fmaxf(m[i], tmax);
            alpha[i] = expf(m[i] - mn);
            float add = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx * 4 + j;
                const float p = (c0 + c < V) ? expf(acc[i][j] - mn) : 0.0f;
                Ps[c][ty * 4 + i] = p;
                add += p;
            }
            s[i] = s[i] * alpha[i] + add;
            m[i] = mn;
        }
        for (int j0 = 0; j0 < k2; j0 += 64) {
#pragma unroll
            for (int l = 0; l < (BN * 64) / THREADS; ++l) {
                const int e = tid + l * THREADS;
                const int c = e / 64;
                const int jj = e % 64;
                const int v = c0 + c;
                const int j = j0 + jj;
                Rs[c][jj] = (v < V && j < k2) ? r_v[(size_t)v * k2 + j]
                                              : 0.0f;
            }
            __syncthreads();
            float e4[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) e4[i][jj] = 0.0f;
#pragma unroll 8
            for (int c = 0; c < BN; ++c) {
                float a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = Ps[c][ty * 4 + i];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) b[jj] = Rs[c][tx * 4 + jj];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj)
                        e4[i][jj] = fmaf(a[i], b[jj], e4[i][jj]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int j = j0 + tx * 4 + jj;
                    if (j < k2) {
                        float& es = Es[(ty * 4 + i) * k2 + j];
                        es = es * alpha[i] + e4[i][jj];
                    }
                }
            __syncthreads();
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = r0 + ty * 4 + i;
            if (row < n) {
                const size_t o = ((size_t)split * U + u) * n + row;
                m_part[o] = m[i];
                s_part[o] = s[i];
            }
        }
    }
    for (int e = tid; e < BM * k2; e += THREADS) {
        const int row = r0 + e / k2;
        if (row < n)
            er2_part[(((size_t)split * U + u) * n + row) * k2 + e % k2] =
                Es[e];
    }
}

// out[u][a][j] = sum_rows hr[u][row][a] * er2[row][j], rows in order,
// with er2 the splits merged in split order: M = max over splits of m,
// S = sum of s exp(m - M), er2 = (sum of er2_part exp(m - M)) /
// max(S, 1e-30) - rvt, times scale.
__global__ void __launch_bounds__(THREADS)
gs_finalize(const float* __restrict__ hr, const float* __restrict__ rvt,
            const float* __restrict__ scale,
            const float* __restrict__ m_part,
            const float* __restrict__ s_part,
            const float* __restrict__ er2_part, float* __restrict__ out,
            int n, int k1, int k2, int S) {
    __shared__ float Hs[FR][BM + 1];
    __shared__ float Gs[FR][BM + 1];
    __shared__ float Mr[FR];                      // the row's max M
    __shared__ float Ir[FR];                      // 1 / max(S, 1e-30)
    const int j0 = blockIdx.x * 64;
    const int a0 = blockIdx.y * 64;
    const int u = blockIdx.z;
    const int U = gridDim.z;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int n0 = 0; n0 < n; n0 += FR) {
        if (tid < FR && n0 + tid < n) {
            const size_t o = (size_t)u * n + n0 + tid;
            const size_t stride = (size_t)U * n;
            float mx = NEG;
            for (int sp = 0; sp < S; ++sp)
                mx = fmaxf(mx, m_part[sp * stride + o]);
            float sum = 0.0f;
            for (int sp = 0; sp < S; ++sp)
                sum += s_part[sp * stride + o] * expf(m_part[sp * stride + o]
                                                     - mx);
            Mr[tid] = mx;
            Ir[tid] = 1.0f / fmaxf(sum, 1e-30f);
        }
        __syncthreads();
#pragma unroll
        for (int l = 0; l < (FR * 64) / THREADS; ++l) {
            const int e = tid + l * THREADS;
            const int r = e / 64;
            const int c = e % 64;
            const int row = n0 + r;
            const int a = a0 + c;
            const int j = j0 + c;
            const size_t ur = (size_t)u * n + row;
            Hs[r][c] = (row < n && a < k1) ? hr[ur * k1 + a] : 0.0f;
            float g = 0.0f;
            if (row < n && j < k2) {
                for (int sp = 0; sp < S; ++sp) {
                    const size_t o = (size_t)sp * U * n + ur;
                    g += er2_part[o * k2 + j] * expf(m_part[o] - Mr[r]);
                }
                g = (g * Ir[r] - rvt[ur * k2 + j]) * scale[ur];
            }
            Gs[r][c] = g;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < FR; ++r) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Hs[r][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Gs[r][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int a = a0 + ty * 4 + i;
        if (a >= k1) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int jj = j0 + tx * 4 + j;
            if (jj < k2) out[((size_t)u * k1 + a) * k2 + jj] = acc[i][j];
        }
    }
}

// The two kernels in order on ``stream``; returns the first launch
// error (cudaSuccess = 0).  Scratch: m_part, s_part (S, U, n) and
// er2_part (S, U, n, k2), all written before they are read.
extern "C" int grad_sketch_units_launch(
    const float* h, const float* wt, const float* r_v, const float* hr,
    const float* rvt, const float* scale, float* m_part, float* s_part,
    float* er2_part, float* out, int U, int n, int d, int V, int k1, int k2,
    int S, int tiles_per_split, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int dyn = BM * k2 * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        gs_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(S, (n + BM - 1) / BM, U);
    gs_partial<<<grid, THREADS, dyn, st>>>(h, wt, r_v, m_part, s_part,
                                           er2_part, n, d, V, k2,
                                           tiles_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid2((k2 + 63) / 64, (k1 + 63) / 64, U);
    gs_finalize<<<grid2, THREADS, 0, st>>>(hr, rvt, scale, m_part, s_part,
                                           er2_part, out, n, k1, k2, S);
    return (int)cudaGetLastError();
}
