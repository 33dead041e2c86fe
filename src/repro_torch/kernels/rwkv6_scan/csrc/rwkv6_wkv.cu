// Chunk-parallel RWKV6 WKV recurrence for Hopper (sm_90a), forward and
// backward, fp32 in and out.
//
// Forward: replaces the Pallas TPU kernel
// src/repro/kernels/rwkv6_scan/kernel.py (rwkv6_wkv, body _wkv_kernel),
// which is the reference's models/rwkv6.py:wkv_chunked moved into VMEM.
// Per (batch, head) lane and chunk of C tokens, with lw = log(clip(w))
// computed outside (so autograd carries its gradient):
//
//   cum_i  = sum_{j<=i} lw_j,   cp_i = cum_i - lw_i          (per channel)
//   y      = (r * e^{cp}) S + [sum_n r_in k_jn e^{min(cp_in - cum_jn, 0)}]_{j<i} v
//            + (r_i . (u * k_i)) v_i
//   S'     = diag(e^{cum_C}) S + (k * e^{cum_C - cum})^T v
//
// Backward: replaces jax.grad of models/rwkv6.py:wkv_chunked (the
// reference has no backward kernel).  It runs the chunk algebra in
// reverse, carrying dS from the last chunk to the first and starting
// each chunk from the state the forward saved at its start, so nothing
// divides by a decay (a per-step reverse scan that recovers S_{t-1} as
// (S_t - k v) / w blows up at decays near 1e-6).  The gradient through
// min(., 0) is taken whole: the pairwise exponents are <= 0 except where
// rounding makes the j = i - 1 one a few ulp positive, and that term's
// contributions to dlw cancel exactly in the algebra (it is sum over an
// empty range); exact ties (w rounding to 1.0) differ from autodiff,
// which splits the gradient there.
//
// What bounds it on this card: bytes.  The forward reads r, k, v, lw and
// writes y (5 B S H N floats) plus the chunk states; its least work is
// ~4 N^2 FLOP per (token, head), far below the fp32 ridge.  This kernel
// is the simple first version and does not reach that bound: it forms
// the C x C pairwise matrix with one expf per (i, j, n) term in fp32
// SIMT arithmetic (C^2 N / 2 exps a chunk in the forward, 3 C^2 N / 2
// in the backward), and runs one block per lane, 160 blocks at the
// rwkv6-3b shape (B 4, H 40) against 132 SMs.
//
// Design: one block of 512 threads per (b, h) lane loops over the chunks
// in order, so the state needs no cross-block carry.  A chunk's r, k, v,
// lw (and dy) rows are read in place from the (B, S, H, N) tensors
// (consecutive threads on consecutive n: each row is N contiguous
// floats) into shared memory with rows padded to N + 1 floats, and the
// state stays in shared memory across chunks.  Every phase is a
// grid-stride loop over its entries with fixed-order sums, no atomics:
// two launches on the same inputs agree bit for bit.  The forward also
// writes the state at the start of every chunk (B H, S/C, N, N) for the
// backward when asked to.  du is written per lane; the wrapper sums it
// over the batch.
#include <cuda_runtime.h>

#define THREADS 512
#define MAXN 64
#define MAXC 64

namespace {

struct Dims {
    int B, S, H, N, C, nC;
};

// Offset of (b, s, h, 0) in a contiguous (B, S, H, N) tensor.
__device__ __forceinline__ size_t row_off(const Dims& d, int b, int s, int h) {
    return (((size_t)b * d.S + s) * d.H + h) * d.N;
}

__device__ __forceinline__ float pair_decay(float cp_i, float cum_j) {
    return expf(fminf(cp_i - cum_j, 0.0f));
}

__global__ void __launch_bounds__(THREADS)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, float* __restrict__ y,
               float* __restrict__ s_out, float* __restrict__ states,
               Dims d) {
    extern __shared__ float smem[];
    const int N = d.N, C = d.C, P = d.N + 1, PC = d.C + 1;
    float* rs = smem;                 // r, then r * e^{cp}       (C x P)
    float* ks = rs + C * P;           // k, then k * e^{tot-cum}  (C x P)
    float* vs = ks + C * P;           // v                        (C x P)
    float* cs = vs + C * P;           // lw, then cum             (C x P)
    float* ps = cs + C * P;           // cp = cum - lw            (C x P)
    float* As = ps + C * P;           // pairwise matrix          (C x PC)
    float* Ss = As + C * PC;          // state [k-dim][v-dim]     (N x P)
    float* dg = Ss + N * P;           // diagonal bonus           (C)

    const int lane = blockIdx.x;
    const int b = lane / d.H, h = lane % d.H;
    const int tid = threadIdx.x;

    for (int e = tid; e < N * N; e += THREADS)
        Ss[(e / N) * P + e % N] = 0.0f;

    for (int c = 0; c < d.nC; ++c) {
        // 1. load the chunk; save the state at its start
        for (int e = tid; e < C * N; e += THREADS) {
            const int i = e / N, n = e % N;
            const size_t o = row_off(d, b, c * C + i, h) + n;
            rs[i * P + n] = r[o];
            ks[i * P + n] = k[o];
            vs[i * P + n] = v[o];
            cs[i * P + n] = lw[o];
        }
        if (states != nullptr) {
            float* st = states + ((size_t)lane * d.nC + c) * N * N;
            for (int e = tid; e < N * N; e += THREADS)
                st[e] = Ss[(e / N) * P + e % N];
        }
        __syncthreads();
        // 2. cumulative log-decays, one thread per channel
        if (tid < N) {
            float acc = 0.0f;
            for (int i = 0; i < C; ++i) {
                const float l = cs[i * P + tid];
                acc += l;
                cs[i * P + tid] = acc;
                ps[i * P + tid] = acc - l;
            }
        }
        __syncthreads();
        // 3. strictly-lower pairwise matrix and the diagonal bonus
        for (int e = tid; e < C * C; e += THREADS) {
            const int i = e / C, j = e % C;
            float a = 0.0f;
            if (j < i)
                for (int n = 0; n < N; ++n)
                    a += rs[i * P + n] * ks[j * P + n]
                         * pair_decay(ps[i * P + n], cs[j * P + n]);
            As[i * PC + j] = a;
        }
        for (int i = tid; i < C; i += THREADS) {
            float a = 0.0f;
            for (int n = 0; n < N; ++n)
                a += rs[i * P + n] * (ks[i * P + n] * u[h * N + n]);
            dg[i] = a;
        }
        __syncthreads();
        // 4. decayed r and k, in place
        for (int e = tid; e < C * N; e += THREADS) {
            const int i = e / N, n = e % N;
            rs[i * P + n] *= expf(ps[i * P + n]);
            ks[i * P + n] *= expf(cs[(C - 1) * P + n] - cs[i * P + n]);
        }
        __syncthreads();
        // 5. y = r_dec S + A v + diag v
        for (int e = tid; e < C * N; e += THREADS) {
            const int i = e / N, m = e % N;
            float inter = 0.0f, intra = 0.0f;
            for (int n = 0; n < N; ++n) inter += rs[i * P + n] * Ss[n * P + m];
            for (int j = 0; j < i; ++j) intra += As[i * PC + j] * vs[j * P + m];
            y[row_off(d, b, c * C + i, h) + m] =
                (inter + intra) + dg[i] * vs[i * P + m];
        }
        __syncthreads();
        // 6. state update S' = diag(e^{tot}) S + k_dec^T v
        for (int e = tid; e < N * N; e += THREADS) {
            const int n = e / N, m = e % N;
            float a = 0.0f;
            for (int j = 0; j < C; ++j) a += ks[j * P + n] * vs[j * P + m];
            Ss[n * P + m] = expf(cs[(C - 1) * P + n]) * Ss[n * P + m] + a;
        }
        __syncthreads();
    }
    float* so = s_out + (size_t)lane * N * N;
    for (int e = tid; e < N * N; e += THREADS)
        so[e] = Ss[(e / N) * P + e % N];
}

__global__ void __launch_bounds__(THREADS)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ states,
               const float* __restrict__ dy, const float* __restrict__ ds_out,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dlw,
               float* __restrict__ du_lane, Dims d) {
    extern __shared__ float smem[];
    const int N = d.N, C = d.C, P = d.N + 1, PC = d.C + 1;
    float* rs = smem;                 // r                         (C x P)
    float* ks = rs + C * P;           // k                         (C x P)
    float* vs = ks + C * P;           // v, then g = dk_dec k_dec  (C x P)
    float* ys = vs + C * P;           // dy                        (C x P)
    float* cs = ys + C * P;           // lw, cum, then d(cum) all  (C x P)
    float* ps = cs + C * P;           // cp, then d(cp)            (C x P)
    float* rd = ps + C * P;           // r * e^{cp}                (C x P)
    float* kd = rd + C * P;           // k * e^{tot - cum}         (C x P)
    float* As = kd + C * P;           // pairwise matrix           (C x PC)
    float* dA = As + C * PC;          // its gradient (masked)     (C x PC)
    float* Ss = dA + C * PC;          // state at the chunk start  (N x P)
    float* dS = Ss + N * P;           // gradient of the state after it
    float* dg = dS + N * P;           // diagonal bonus            (C)
    float* ddg = dg + MAXC;           // its gradient              (C)
    float* tt = ddg + MAXC;           // tot = cum_{C-1}           (N)

    const int lane = blockIdx.x;
    const int b = lane / d.H, h = lane % d.H;
    const int tid = threadIdx.x;
    float du_acc = 0.0f;              // thread n < N: sum over chunks

    for (int e = tid; e < N * N; e += THREADS)
        dS[(e / N) * P + e % N] = ds_out[(size_t)lane * N * N + e];

    for (int c = d.nC - 1; c >= 0; --c) {
        // 1. load the chunk and the state at its start
        for (int e = tid; e < C * N; e += THREADS) {
            const int i = e / N, n = e % N;
            const size_t o = row_off(d, b, c * C + i, h) + n;
            rs[i * P + n] = r[o];
            ks[i * P + n] = k[o];
            vs[i * P + n] = v[o];
            ys[i * P + n] = dy[o];
            cs[i * P + n] = lw[o];
        }
        const float* st = states + ((size_t)lane * d.nC + c) * N * N;
        for (int e = tid; e < N * N; e += THREADS)
            Ss[(e / N) * P + e % N] = st[e];
        __syncthreads();
        // 2. cumulative log-decays
        if (tid < N) {
            float acc = 0.0f;
            for (int i = 0; i < C; ++i) {
                const float l = cs[i * P + tid];
                acc += l;
                cs[i * P + tid] = acc;
                ps[i * P + tid] = acc - l;
            }
            tt[tid] = acc;
        }
        __syncthreads();
        // 3. A and dA = (dy v^T) masked; diag and its gradient; decayed
        //    r and k
        for (int e = tid; e < C * C; e += THREADS) {
            const int i = e / C, j = e % C;
            float a = 0.0f, da = 0.0f;
            if (j < i) {
                for (int n = 0; n < N; ++n)
                    a += rs[i * P + n] * ks[j * P + n]
                         * pair_decay(ps[i * P + n], cs[j * P + n]);
                for (int m = 0; m < N; ++m)
                    da += ys[i * P + m] * vs[j * P + m];
            }
            As[i * PC + j] = a;
            dA[i * PC + j] = da;
        }
        for (int i = tid; i < C; i += THREADS) {
            float a = 0.0f, da = 0.0f;
            for (int n = 0; n < N; ++n) {
                a += rs[i * P + n] * (ks[i * P + n] * u[h * N + n]);
                da += ys[i * P + n] * vs[i * P + n];
            }
            dg[i] = a;
            ddg[i] = da;
        }
        for (int e = tid; e < C * N; e += THREADS) {
            const int i = e / N, n = e % N;
            rd[i * P + n] = rs[i * P + n] * expf(ps[i * P + n]);
            kd[i * P + n] = ks[i * P + n] * expf(tt[n] - cs[i * P + n]);
        }
        __syncthreads();
        // 4. per (i, n): dr, dk, and the gradients of cp and cum, kept in
        //    registers until every thread has read r, k, v, cum and cp
        constexpr int PER = (MAXC * MAXN + THREADS - 1) / THREADS;
        float g_reg[PER], dcp_reg[PER], dct_reg[PER];
#pragma unroll
        for (int t = 0; t < PER; ++t) {
            const int e = tid + t * THREADS;
            if (e >= C * N) break;
            const int i = e / N, n = e % N;
            const float cp_i = ps[i * P + n], cum_i = cs[i * P + n];
            float drdec = 0.0f, dkdec = 0.0f, pv = 0.0f, qv = 0.0f;
            for (int m = 0; m < N; ++m) {
                drdec += ys[i * P + m] * Ss[n * P + m];
                dkdec += vs[i * P + m] * dS[n * P + m];
            }
            for (int j = 0; j < i; ++j)
                pv += dA[i * PC + j] * ks[j * P + n]
                      * pair_decay(cp_i, cs[j * P + n]);
            for (int l = i + 1; l < C; ++l)
                qv += dA[l * PC + i] * rs[l * P + n]
                      * pair_decay(ps[l * P + n], cum_i);
            const float ri = rs[i * P + n], ki = ks[i * P + n];
            const float ud = ddg[i] * u[h * N + n];
            const size_t o = row_off(d, b, c * C + i, h) + n;
            dr[o] = drdec * expf(cp_i) + pv + ud * ki;
            dk[o] = dkdec * expf(tt[n] - cum_i) + qv + ud * ri;
            const float dcp = drdec * rd[i * P + n] + ri * pv;
            const float g = dkdec * kd[i * P + n];
            g_reg[t] = g;
            dcp_reg[t] = dcp;
            dct_reg[t] = (-ki * qv - g) + dcp;
        }
        __syncthreads();
#pragma unroll
        for (int t = 0; t < PER; ++t) {
            const int e = tid + t * THREADS;
            if (e >= C * N) break;
            const int i = e / N, n = e % N;
            vs[i * P + n] = g_reg[t];
            ps[i * P + n] = dcp_reg[t];
            cs[i * P + n] = dct_reg[t];
        }
        __syncthreads();
        // 5a. per channel: d(tot), then dlw = reverse cumsum of d(cum)
        //     (d(tot) entering at the last row) minus d(cp); du
        if (tid < N) {
            const int n = tid;
            float sds = 0.0f, gs = 0.0f, dus = 0.0f;
            for (int m = 0; m < N; ++m) sds += Ss[n * P + m] * dS[n * P + m];
            for (int i = 0; i < C; ++i) {
                gs += vs[i * P + n];
                dus += ddg[i] * (rs[i * P + n] * ks[i * P + n]);
            }
            du_acc += dus;
            float acc = gs + sds * expf(tt[n]);
            for (int i = C - 1; i >= 0; --i) {
                acc += cs[i * P + n];
                dlw[row_off(d, b, c * C + i, h) + n] = acc - ps[i * P + n];
            }
        }
        // 5b. dv = A^T dy + diag dy + k_dec dS'
        for (int e = tid; e < C * N; e += THREADS) {
            const int j = e / N, m = e % N;
            float a = 0.0f, s = 0.0f;
            for (int i = j + 1; i < C; ++i) a += As[i * PC + j] * ys[i * P + m];
            for (int n = 0; n < N; ++n) s += kd[j * P + n] * dS[n * P + m];
            dv[row_off(d, b, c * C + j, h) + m] =
                (a + dg[j] * ys[j * P + m]) + s;
        }
        __syncthreads();
        // 6. gradient of the state at the chunk start:
        //    dS <- diag(e^{tot}) dS + r_dec^T dy
        for (int e = tid; e < N * N; e += THREADS) {
            const int n = e / N, m = e % N;
            float a = 0.0f;
            for (int i = 0; i < C; ++i) a += rd[i * P + n] * ys[i * P + m];
            dS[n * P + m] = expf(tt[n]) * dS[n * P + m] + a;
        }
        __syncthreads();
    }
    if (tid < N) du_lane[(size_t)lane * N + tid] = du_acc;
}

size_t fwd_smem(int C, int N) {
    return sizeof(float) * (5 * C * (N + 1) + C * (C + 1) + N * (N + 1) + C);
}

size_t bwd_smem(int C, int N) {
    return sizeof(float) * (8 * C * (N + 1) + 2 * C * (C + 1)
                            + 2 * N * (N + 1) + 2 * MAXC + MAXN);
}

}  // namespace

extern "C" int rwkv6_wkv_fwd_launch(const float* r, const float* k,
                                    const float* v, const float* lw,
                                    const float* u, float* y, float* s_out,
                                    float* states, int B, int S, int H, int N,
                                    int C, void* stream) {
    if (N < 1 || N > MAXN || C < 1 || C > MAXC || S % C != 0)
        return (int)cudaErrorInvalidValue;
    const Dims d{B, S, H, N, C, S / C};
    const size_t smem = fwd_smem(C, N);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    wkv_fwd_kernel<<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
        r, k, v, lw, u, y, s_out, states, d);
    return (int)cudaGetLastError();
}

extern "C" int rwkv6_wkv_bwd_launch(const float* r, const float* k,
                                    const float* v, const float* lw,
                                    const float* u, const float* states,
                                    const float* dy, const float* ds_out,
                                    float* dr, float* dk, float* dv,
                                    float* dlw, float* du_lane, int B, int S,
                                    int H, int N, int C, void* stream) {
    if (N < 1 || N > MAXN || C < 1 || C > MAXC || S % C != 0)
        return (int)cudaErrorInvalidValue;
    const Dims d{B, S, H, N, C, S / C};
    const size_t smem = bwd_smem(C, N);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    wkv_bwd_kernel<<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
        r, k, v, lw, u, states, dy, ds_out, dr, dk, dv, dlw, du_lane, d);
    return (int)cudaGetLastError();
}
