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
// What bounds them on this card: bytes.  The forward reads r, k, v, lw
// and writes y (5 B S H N floats) plus the chunk states; its least work
// is ~4 N^2 FLOP per (token, head), far below the fp32 ridge.
//
// Forward design: three launches, parallel over (lane, chunk) where the
// recurrence allows it (1,280 blocks at the rwkv6-3b shape, B 4, H 40,
// S 512, C 64), so the card is full:
//   (a) wkv_chunk_kernel, a block per (lane, chunk): the chunk's own
//       state increment dS_c = (k e^{tot - cum})^T v and its total decay
//       tot = cum_{C-1}, into the chunk-state buffer and a tot buffer;
//   (b) wkv_scan_kernel, a thread per (lane, n, m) state entry: the
//       ordered scan S_0 = 0, S_{c+1} = e^{tot_c} S_c + dS_c, in place,
//       so the buffer ends holding the state at the start of every chunk
//       (what the backward reads) and the final state goes to s_out;
//   (c) wkv_out_kernel, a block per (lane, chunk): y = r_dec S_c +
//       intra-chunk + diagonal bonus.
// Far fewer exponentials: the chunk is cut into sub-chunks of 16 tokens.
// A diagonal sub-block (i, j in the same sub-chunk, j < i) keeps the
// exact pairwise e^{min(cp_i - cum_j, 0)}; an off-diagonal one (i in
// sub-chunk I, j in an earlier J whose last token is b) factorises as
// e^{cp_i - cum_b} e^{cum_b - cum_j}, both exponents <= 0 (a float sum of
// non-positive lw never grows) and each clamped at 0, so nothing
// overflows even at the 1e-8 clip (lw = -18.42 a token, -1,179 over a
// 64-token chunk), and the sub-block becomes a small product (r e^{cp -
// cum_b}) (k e^{cum_b - cum})^T.  A single factorisation across the whole
// chunk about one reference point would overflow fp32 at such decays.
// At C = 64 that is ~9k exponentials for the off-diagonal sub-blocks and
// ~31k for the diagonal ones a chunk, against C^2 N / 2 = 131k before.
// Rows are read with 16-byte loads where N % 4 == 0 and the rows are
// 16-byte aligned.  Every sum runs in a fixed order and there are no
// atomics: two launches on the same inputs agree bit for bit.  The
// wrapper counts the three launches as one forward launch.
//
// Tried and dropped: the first port ran one block of 512
// threads per lane over its chunks in order (160 blocks on 132 SMs, a
// full wave and a second of 28) with one accurate expf per pairwise term:
// 0.87 ms at the rwkv6-3b shape on an H100, 23x its bytes bound.
//
// Backward design: one block of 512 threads per (b, h) lane loops over
// the chunks from the last to the first, dS carried in shared memory.  A
// chunk's r, k, v, lw and dy rows are read in place from the (B, S, H, N)
// tensors into shared memory with rows padded to N + 1 floats.  Every
// phase is a grid-stride loop over its entries with fixed-order sums, no
// atomics.  du is written per lane; the wrapper sums it over the batch.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define THREADS_F 256
#define MAXN 64
#define MAXC 64
#define SUB 16

namespace {

struct Dims {
    int B, S, H, N, C, nC, vec;
};

// Offset of (b, s, h, 0) in a contiguous (B, S, H, N) tensor.
__device__ __forceinline__ size_t row_off(const Dims& d, int b, int s, int h) {
    return (((size_t)b * d.S + s) * d.H + h) * d.N;
}

__device__ __forceinline__ float pair_decay(float cp_i, float cum_j) {
    return expf(fminf(cp_i - cum_j, 0.0f));
}

// e^{min(x, 0)} for the forward's decays: the exponent is formed as a
// difference first (a small number, exact or nearly so), then scaled into
// base 2 for ex2 (~2 ulp), fewer instructions than expf's range reduction
__device__ __forceinline__ float decay_exp(float x) {
    return exp2f(fminf(x, 0.0f) * 1.4426950408889634f);
}

// The C rows of chunk c of lane (b, h) of a (B, S, H, N) tensor into a
// (C, N + 1) shared array: 16-byte loads when d.vec (N % 4 == 0 and every
// tensor 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           const Dims& d, int b, int c,
                                           int h) {
    const int N = d.N, P = N + 1;
    if (d.vec) {
        const int N4 = N / 4;
        for (int e = threadIdx.x; e < d.C * N4; e += blockDim.x) {
            const int i = e / N4, q = e % N4;
            const float4 x = *reinterpret_cast<const float4*>(
                src + row_off(d, b, c * d.C + i, h) + 4 * q);
            float* o = dst + i * P + 4 * q;
            o[0] = x.x;
            o[1] = x.y;
            o[2] = x.z;
            o[3] = x.w;
        }
    } else {
        for (int e = threadIdx.x; e < d.C * N; e += blockDim.x) {
            const int i = e / N, n = e % N;
            dst[i * P + n] = src[row_off(d, b, c * d.C + i, h) + n];
        }
    }
}

// cs holds lw; turn it into cum = its running sum over the chunk, one
// thread a channel.
__device__ __forceinline__ void chunk_cumsum(float* cs, const Dims& d) {
    const int P = d.N + 1;
    if (threadIdx.x < d.N) {
        float acc = 0.0f;
        for (int i = 0; i < d.C; ++i) {
            acc += cs[i * P + threadIdx.x];
            cs[i * P + threadIdx.x] = acc;
        }
    }
}

// (a) dS_c[n][m] = sum_j k_j[n] e^{tot[n] - cum_j[n]} v_j[m] into the
// chunk-state buffer, and tot = cum_{C-1}.
__global__ void __launch_bounds__(THREADS_F)
wkv_chunk_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ lw, float* __restrict__ states,
                 float* __restrict__ tot, Dims d) {
    extern __shared__ float smem[];
    const int N = d.N, C = d.C, P = d.N + 1;
    float* ks = smem;                 // k, then k * e^{tot - cum}  (C x P)
    float* vs = ks + C * P;           // v                          (C x P)
    float* cs = vs + C * P;           // lw, then cum               (C x P)
    const int lane = blockIdx.x / d.nC, c = blockIdx.x % d.nC;
    const int b = lane / d.H, h = lane % d.H;
    const int tid = threadIdx.x;

    load_chunk(ks, k, d, b, c, h);
    load_chunk(vs, v, d, b, c, h);
    load_chunk(cs, lw, d, b, c, h);
    __syncthreads();
    chunk_cumsum(cs, d);
    __syncthreads();
    const float* tt = cs + (C - 1) * P;
    for (int e = tid; e < C * N; e += THREADS_F) {
        const int i = e / N, n = e % N;
        ks[i * P + n] *= decay_exp(tt[n] - cs[i * P + n]);
    }
    if (tid < N) tot[((size_t)lane * d.nC + c) * N + tid] = tt[tid];
    __syncthreads();
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.0f;
    for (int j = 0; j < C; ++j) {
        float kk[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            kk[a] = ty + 16 * a < N ? ks[j * P + ty + 16 * a] : 0.0f;
            vv[a] = tx + 16 * a < N ? vs[j * P + tx + 16 * a] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(kk[a], vv[q], acc[a][q]);
    }
    float* ds = states + ((size_t)lane * d.nC + c) * N * N;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int n = ty + 16 * a, m = tx + 16 * q;
            if (n < N && m < N) ds[n * N + m] = acc[a][q];
        }
}

// (b) per state entry (lane, n, m), chunks in order: the buffer's dS_c is
// replaced by the state at chunk c's start; the final state to s_out.
__global__ void __launch_bounds__(THREADS_F)
wkv_scan_kernel(float* __restrict__ states, const float* __restrict__ tot,
                float* __restrict__ s_out, Dims d) {
    const int NN = d.N * d.N;
    const size_t e = (size_t)blockIdx.x * THREADS_F + threadIdx.x;
    if (e >= (size_t)d.B * d.H * NN) return;
    const size_t lane = e / NN;
    const int nm = (int)(e % NN), n = nm / d.N;
    float S = 0.0f;
    // 8 chunks' loads in flight at a time, then their steps in order
    for (int c0 = 0; c0 < d.nC; c0 += 8) {
        float ds[8], dec[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
            if (c0 + q < d.nC) {
                const size_t lc = lane * d.nC + c0 + q;
                ds[q] = states[lc * NN + nm];
                dec[q] = tot[lc * d.N + n];
            }
#pragma unroll
        for (int q = 0; q < 8; ++q)
            if (c0 + q < d.nC) {
                states[(lane * d.nC + c0 + q) * NN + nm] = S;
                S = expf(dec[q]) * S + ds[q];
            }
    }
    s_out[lane * NN + nm] = S;
}

// (c) y of one (lane, chunk) from the state at its start.
__global__ void __launch_bounds__(THREADS_F)
wkv_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u,
               const float* __restrict__ states, float* __restrict__ y,
               Dims d) {
    extern __shared__ float smem[];
    const int N = d.N, C = d.C, P = d.N + 1, PC = d.C + 1;
    float* rs = smem;                 // r, then r * e^{cp}         (C x P)
    float* ks = rs + C * P;           // k, then k e^{cum_b - cum}  (C x P)
    float* vs = ks + C * P;           // v                          (C x P)
    float* cs = vs + C * P;           // lw, then cum               (C x P)
    float* Ss = cs + C * P;           // state at the chunk start   (N x P)
    float* As = Ss + N * P;           // pairwise matrix, j < i     (C x PC)
    float* dg = As + C * PC;          // diagonal bonus             (C)
    const int lane = blockIdx.x / d.nC, c = blockIdx.x % d.nC;
    const int b = lane / d.H, h = lane % d.H;
    const int tid = threadIdx.x;
    const int nsub = (C + SUB - 1) / SUB;

    load_chunk(rs, r, d, b, c, h);
    load_chunk(ks, k, d, b, c, h);
    load_chunk(vs, v, d, b, c, h);
    load_chunk(cs, lw, d, b, c, h);
    const float* st = states + ((size_t)lane * d.nC + c) * N * N;
    if (d.vec) {
        for (int e = tid; e < N * N / 4; e += THREADS_F) {
            const float4 x = reinterpret_cast<const float4*>(st)[e];
            const int n = (4 * e) / N, m = (4 * e) % N;
            float* o = Ss + n * P + m;
            o[0] = x.x;
            o[1] = x.y;
            o[2] = x.z;
            o[3] = x.w;
        }
    } else {
        for (int e = tid; e < N * N; e += THREADS_F)
            Ss[(e / N) * P + e % N] = st[e];
    }
    __syncthreads();
    chunk_cumsum(cs, d);
    __syncthreads();
    // cp_i = cum_{i-1} (0 at i = 0): a float sum of non-positive terms,
    // so cp_i <= cum_j for every j < i
#define CP(i, n) ((i) > 0 ? cs[((i) - 1) * P + (n)] : 0.0f)
    // 1. the diagonal bonus, the diagonal sub-blocks' exact pairwise
    //    terms, and zeros on and above the diagonal
    for (int i = tid; i < C; i += THREADS_F) {
        float a = 0.0f;
        for (int n = 0; n < N; ++n)
            a += rs[i * P + n] * (ks[i * P + n] * u[h * N + n]);
        dg[i] = a;
    }
    for (int e = tid; e < C * C; e += THREADS_F) {
        const int i = e / C, j = e % C;
        if (j >= i) As[i * PC + j] = 0.0f;
    }
    int pairs = 0;                    // sum over sub-chunks of L (L - 1) / 2
    for (int I = 0; I < nsub; ++I) {
        const int L = min(SUB, C - I * SUB);
        pairs += L * (L - 1) / 2;
    }
    for (int p = tid; p < pairs; p += THREADS_F) {
        int q = p, I = 0;
        for (;; ++I) {
            const int L = min(SUB, C - I * SUB);
            if (q < L * (L - 1) / 2) break;
            q -= L * (L - 1) / 2;
        }
        int ai = 1;                   // row ai > column q within the block
        while (q >= ai) {
            q -= ai;
            ++ai;
        }
        const int i = I * SUB + ai, j = I * SUB + q;
        float a = 0.0f;
        for (int n = 0; n < N; ++n)
            a += rs[i * P + n] * ks[j * P + n]
                 * decay_exp(CP(i, n) - cs[j * P + n]);
        As[i * PC + j] = a;
    }
    __syncthreads();
    // 2. k of every sub-chunk but the last, decayed to the sub-chunk's
    //    last token b: k e^{cum_b - cum}
    for (int e = tid; e < (nsub - 1) * SUB * N; e += THREADS_F) {
        const int j = e / N, n = e % N;
        const int bj = (j / SUB) * SUB + SUB - 1;
        ks[j * P + n] *= decay_exp(cs[bj * P + n] - cs[j * P + n]);
    }
    __syncthreads();
    // 3. the off-diagonal sub-blocks: task (i, J, half) gives A[i][j] for
    //    the 8 columns j of that half of sub-chunk J < i's sub-chunk,
    //    sum_n (r_in e^{cp_in - cum_bn}) (k_jn e^{cum_bn - cum_jn})
    int tasks = 0;
    for (int I = 1; I < nsub; ++I) tasks += min(SUB, C - I * SUB) * I * 2;
    for (int t = tid; t < tasks; t += THREADS_F) {
        const int half = t & 1;
        int q = t >> 1, I = 1;
        for (;; ++I) {
            const int cnt = min(SUB, C - I * SUB) * I;
            if (q < cnt) break;
            q -= cnt;
        }
        const int i = I * SUB + q / I, J = q % I;
        const int bj = J * SUB + SUB - 1, j0 = J * SUB + 8 * half;
        float a[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) a[jj] = 0.0f;
        for (int n = 0; n < N; ++n) {
            const float x = rs[i * P + n]
                            * decay_exp(CP(i, n) - cs[bj * P + n]);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
                a[jj] = fmaf(x, ks[(j0 + jj) * P + n], a[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) As[i * PC + j0 + jj] = a[jj];
    }
    __syncthreads();
    // 4. decayed r, in place
    for (int e = tid; e < C * N; e += THREADS_F) {
        const int i = e / N, n = e % N;
        rs[i * P + n] *= decay_exp(CP(i, n));
    }
#undef CP
    __syncthreads();
    // 5. y = (r_dec S + A v) + diag v, a 4 x 4 tile a thread
    const int tx = tid % 16, ty = tid / 16;
    float inter[4][4], intra[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) inter[a][q] = intra[a][q] = 0.0f;
    for (int n = 0; n < N; ++n) {
        float rr[4], ss[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            rr[a] = ty + 16 * a < C ? rs[(ty + 16 * a) * P + n] : 0.0f;
            ss[a] = tx + 16 * a < N ? Ss[n * P + tx + 16 * a] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                inter[a][q] = fmaf(rr[a], ss[q], inter[a][q]);
    }
    for (int j = 0; j < C; ++j) {
        float aa[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            aa[a] = ty + 16 * a < C ? As[(ty + 16 * a) * PC + j] : 0.0f;
            vv[a] = tx + 16 * a < N ? vs[j * P + tx + 16 * a] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                intra[a][q] = fmaf(aa[a], vv[q], intra[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= C) continue;
        float* yo = y + row_off(d, b, c * C + i, h);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int m = tx + 16 * q;
            if (m < N)
                yo[m] = (inter[a][q] + intra[a][q]) + dg[i] * vs[i * P + m];
        }
    }
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

size_t chunk_smem(int C, int N) {
    return sizeof(float) * 3 * C * (N + 1);
}

size_t out_smem(int C, int N) {
    return sizeof(float) * (4 * C * (N + 1) + N * (N + 1) + C * (C + 1) + C);
}

size_t bwd_smem(int C, int N) {
    return sizeof(float) * (8 * C * (N + 1) + 2 * C * (C + 1)
                            + 2 * N * (N + 1) + 2 * MAXC + MAXN);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// The forward's three launches in order on ``stream``; returns the first
// launch error (cudaSuccess = 0).  states (B H, S/C, N, N) and tot (B H,
// S/C, N) are written before they are read; states ends holding the state
// at the start of every chunk.
extern "C" int rwkv6_wkv_fwd_launch(const float* r, const float* k,
                                    const float* v, const float* lw,
                                    const float* u, float* y, float* s_out,
                                    float* states, float* tot, int B, int S,
                                    int H, int N, int C, void* stream) {
    if (N < 1 || N > MAXN || C < 1 || C > MAXC || S % C != 0)
        return (int)cudaErrorInvalidValue;
    const int vec = N % 4 == 0 && aligned16(r) && aligned16(k)
                    && aligned16(v) && aligned16(lw) && aligned16(states);
    const Dims d{B, S, H, N, C, S / C, vec};
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = B * H * d.nC;
    const size_t sm_a = chunk_smem(C, N), sm_c = out_smem(C, N);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm_a);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        wkv_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm_c);
    if (err != cudaSuccess) return (int)err;
    wkv_chunk_kernel<<<blocks, THREADS_F, sm_a, st>>>(k, v, lw, states, tot,
                                                      d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t entries = (size_t)B * H * N * N;
    wkv_scan_kernel<<<(unsigned)((entries + THREADS_F - 1) / THREADS_F),
                      THREADS_F, 0, st>>>(states, tot, s_out, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wkv_out_kernel<<<blocks, THREADS_F, sm_c, st>>>(r, k, v, lw, u, states,
                                                    y, d);
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
    const Dims d{B, S, H, N, C, S / C, 0};
    const size_t smem = bwd_smem(C, N);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    wkv_bwd_kernel<<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
        r, k, v, lw, u, states, dy, ds_out, dr, dk, dv, dlw, du_lane, d);
    return (int)cudaGetLastError();
}
