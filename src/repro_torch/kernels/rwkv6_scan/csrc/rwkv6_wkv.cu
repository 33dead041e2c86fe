// Chunk-parallel RWKV6 WKV recurrence for Hopper (sm_90a), forward and
// backward, fp32 in and out.
//
// Forward: replaces the Pallas TPU kernel
// src/repro/kernels/rwkv6_scan/kernel.py (rwkv6_wkv, body _wkv_kernel),
// which is the reference's models/rwkv6.py:wkv_chunked moved into VMEM.
// Per (batch, head) lane and chunk of C tokens, with lw = log(clip(w))
// computed outside (so autograd carries its gradient):
//
//   cum_i  = sum_{j<=i} lw_j,  cp_i = cum_{i-1} (0 at i = 0)  (per channel)
//   y      = (r * e^{cp}) S
//            + [sum_n r_in k_jn e^{min(cp_in - cum_jn, 0)}]_{j<i} v
//            + (r_i . (u * k_i)) v_i
//   S'     = diag(e^{cum_C}) S + (k * e^{cum_C - cum})^T v
//
// The reference writes cp_i as cum_i - lw_i, the same value in exact
// arithmetic; cum_{i-1} keeps the j = i - 1 decay exactly 1 and stays
// within 1e-6 of a float64 scan where cum - lw sits 2-6e-5 off at C = 64
// under strong decays (tests/test_torch_designs.py).
//
// Backward: replaces jax.grad of models/rwkv6.py:wkv_chunked (the
// reference has no backward kernel), and is the exact gradient of the
// forward's algebra above (cp_i = cum_{i-1}, the same sub-chunks).  Each
// chunk starts from the state the forward saved at its start, so nothing
// divides by a decay (a per-step reverse scan that recovers S_{t-1} as
// (S_t - k v) / w blows up at decays near 1e-6).  The gradient through
// min(., 0) is taken whole: the exponents are <= 0 by construction (a
// float sum of non-positive lw never grows); exact ties (w rounding to
// 1.0) differ from autodiff, which splits the gradient there.
//
// What bounds them on this card: bytes.  The forward reads r, k, v, lw
// and writes y (5 B S H N floats) plus the chunk states; its least work
// is ~4 N^2 FLOP per (token, head), far below the fp32 ridge.  The
// backward reads r, k, v, lw, dy and the chunk states and writes dr, dk,
// dv, dlw; ~8 N^2 FLOP per (token, head).
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
// e^{cp_i - cum_b} e^{cum_b - cum_j}, both exponents <= 0 and each
// clamped at 0, so nothing overflows even at the 1e-8 clip (lw = -18.42
// a token, -1,179 over a 64-token chunk), and the sub-block becomes a
// small product (r e^{cp - cum_b}) (k e^{cum_b - cum})^T.  A single
// factorisation across the whole chunk about one reference point would
// overflow fp32 at such decays.  At C = 64 that is ~9k exponentials for
// the off-diagonal sub-blocks and ~31k for the diagonal ones a chunk,
// against C^2 N / 2 = 131k before.  Rows are read with 16-byte loads
// where N % 4 == 0 and the rows are 16-byte aligned.  Every sum runs in
// a fixed order and there are no atomics: two launches on the same
// inputs agree bit for bit.  The wrapper counts the three launches as
// one forward launch.
//
// Backward design: three launches, the forward's shape run in reverse.
// With D_c the gradient of the state after chunk c (D_{nC-1} = the final
// state's cotangent) and r_dec = r e^{cp}:
//   (a) wkv_bwd_inc_kernel, a block per (lane, chunk c >= 1): the chunk's
//       increment r_dec^T dy (N x N) and its total decay, into a scratch
//       buffer of the chunk-state size and a tot buffer;
//   (b) wkv_bwd_scan_kernel, a thread per (lane, n, m): the ordered
//       reverse scan D_{c-1} = e^{tot_c} D_c + inc_c, in place, leaving
//       D_c in slot c of the scratch buffer;
//   (c) wkv_bwd_grad_kernel, a block per (lane, chunk): from the chunk's
//       start state (the forward's) and D_c, with no carry between
//       blocks: dr, dk, dv, dlw of the chunk and a du partial a (lane,
//       chunk), which the wrapper sums over fixed axes.
// The 64-wide products (dy S^T, v D^T, k_dec D, dy v^T, A^T dy in (c),
// r_dec^T dy in (a)) run on the tensor cores as 3xTF32 mma.sync
// m16n8k8: each operand split into TF32 hi + lo by integer rounding,
// lo.hi + hi.lo + hi.hi, lo.lo dropped; a warp owns a 16-row tile and
// four 8-column tiles, so one A fragment feeds four accumulators.  The
// pairwise terms (A, and the dA-weighted pv = sum_j dA_ij k_j e^{cp_i -
// cum_j} and qv = sum_i dA_ij r_i e^{cp_i - cum_j}) use the forward's
// sub-chunks: exact exponentials on the diagonal sub-blocks; off them,
// two factors with exponents <= 0 (A and pv through the last token of
// j's sub-chunk, qv through the first token of i's).  A's off-diagonal
// sub-blocks are 3xTF32 products too; pv, qv and the row gradients run a
// thread per (sub-chunk, channel), its 16 rows' sums in registers, and
// dlw sums each sub-chunk's rows, then the sub-chunks' totals in order.
// The j = i - 1 terms have a decay of exactly 1 for any lw (cp_i =
// cum_{i-1}): they enter dr and dk but are kept out of the log-decay
// gradients, where the two that the chunk algebra adds (through cp_i and
// through cum_{i-1}) cancel exactly; summing them in anyway left dlw
// ~0.16 of its largest entry off a float64 scan at decays of 1e-6 (the
// plain autograd: ~0.08), against 3e-5 without them.  Block (c) holds
// six chunk-sized arrays and a few short vectors, 108,032 B at C = N =
// 64, so two blocks fit on an SM: the state and its gradient are
// replaced by r and by the pairwise matrices (dA below the diagonal, A
// transposed above it) once the products that read them are done.  Rows
// land by cp.async, 16 bytes a copy where N % 4 == 0 and the rows are
// 16-byte aligned.  No atomics; every sum in a fixed order.  The wrapper
// counts the three launches as one backward launch.
//
// Tried and dropped: the first port ran one block of 512
// threads per lane over its chunks in order (160 blocks on 132 SMs, a
// full wave and a second of 28) with one accurate expf per pairwise term:
// 0.87 ms at the rwkv6-3b shape on an H100, 23x its bytes bound.  Its
// backward had the same shape, carrying dS from the last chunk to the
// first in shared memory (200,448 B, one block an SM), every product
// fp32 SIMT, three loops of C^2 N / 2 accurate expf, and cp = cum - lw:
// 1.8226 ms at the rwkv6-3b shape on an H100 (NVIDIA H100 80GB HBM3,
// 700 W), 29x its bytes bound.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS_F 256     // a forward block, a scan block
#define THREADS_B 256     // a backward block: 8 warps
#define TPW 4             // 16 x 8 mma tiles a warp (64 x 64 / 8)
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

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tf32(x), rounded to nearest with ties away from zero (cvt.rna.tf32.f32)
// as two integer operations on the bits (this source keeps its own copy
// of the grad sketch's split: each source builds alone)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t a[4],
                                         const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// acc += a . b over depth K for the one 16 x 8 tile at (r0, c0), as
// mma_3xtf32 below (3xTF32 on mma.sync m16n8k8).
template <typename FA, typename FB>
__device__ __forceinline__ void mma_tile_3xtf32(float (&acc)[4], int r0,
                                                int c0, int K, FA a, FB b) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        split_tf32(a(r0 + g, k0 + t), ah[0], al[0]);
        split_tf32(a(r0 + g + 8, k0 + t), ah[1], al[1]);
        split_tf32(a(r0 + g, k0 + t + 4), ah[2], al[2]);
        split_tf32(a(r0 + g + 8, k0 + t + 4), ah[3], al[3]);
        split_tf32(b(k0 + t, c0 + g), bh[0], bl[0]);
        split_tf32(b(k0 + t + 4, c0 + g), bh[1], bl[1]);
        mma_tf32(acc, al, bh);
        mma_tf32(acc, ah, bl);
        mma_tf32(acc, ah, bh);
    }
}

// acc[s] += a . b over depth K for the 16 x 8 tiles of a (rows x cols)
// output (rows, cols <= 64) that this warp owns: row tile warp / 2 and
// the four column tiles 4 (warp % 2) + s, so one A fragment a k step
// serves four independent accumulators.  3xTF32 on mma.sync m16n8k8:
// lo.hi + hi.lo + hi.hi.  a(row, k) and b(k, col) read shared memory and
// return 0 outside (rows, K) and (K, cols).  Fragment layout (PTX ISA,
// m16n8k8 .tf32): g = lane / 4, t = lane % 4; a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); c_e at row
// g + 8 (e / 2), column 2 t + e % 2.
template <typename FA, typename FB>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[TPW][4], int rows,
                                           int K, FA a, FB b) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
              t = threadIdx.x & 3;
    const int r0 = (warp >> 1) * 16, c0 = (warp & 1) * TPW * 8;
    if (r0 >= rows) return;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
        uint32_t ah[4], al[4];
        split_tf32(a(r0 + g, k0 + t), ah[0], al[0]);
        split_tf32(a(r0 + g + 8, k0 + t), ah[1], al[1]);
        split_tf32(a(r0 + g, k0 + t + 4), ah[2], al[2]);
        split_tf32(a(r0 + g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
        for (int s = 0; s < TPW; ++s) {
            uint32_t bh[2], bl[2];
            split_tf32(b(k0 + t, c0 + 8 * s + g), bh[0], bl[0]);
            split_tf32(b(k0 + t + 4, c0 + 8 * s + g), bh[1], bl[1]);
            mma_tf32(acc[s], al, bh);
            mma_tf32(acc[s], ah, bl);
            mma_tf32(acc[s], ah, bh);
        }
    }
}

// (row, col) of accumulator entry e of tile s of this thread, as
// mma_3xtf32 walks an output of ``rows`` rows; row -1 when the warp has
// no rows there.
__device__ __forceinline__ void tile_pos(int s, int e, int rows, int& row,
                                         int& col) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
              t = threadIdx.x & 3;
    const int r0 = (warp >> 1) * 16;
    row = r0 >= rows ? -1 : r0 + g + 8 * (e >> 1);
    col = ((warp & 1) * TPW + s) * 8 + 2 * t + (e & 1);
}

// Shared-memory layout of the backward's blocks: rows of width N padded
// to PN (a multiple of 4, + 4, so 16-byte copies land aligned and the
// fragment reads spread over the banks), pairwise rows to PC.
struct BwdLayout {
    int PN, PC, row, flex;
};

__host__ __device__ __forceinline__ BwdLayout bwd_layout(int C, int N) {
    BwdLayout L;
    L.PN = ((N + 3) & ~3) + 4;
    L.PC = ((C + 3) & ~3) + 4;
    L.row = C * L.PN;
    L.flex = (C > N ? C : N) * (L.PN > L.PC ? L.PN : L.PC);
    return L;
}

// The C rows of chunk c of lane (b, h) of a (B, S, H, N) tensor into a
// (C, ld) shared array by cp.async (16-byte copies when d.vec, else 4);
// the caller commits and waits.
__device__ __forceinline__ void load_chunk_async(float* dst, int ld,
                                                 const float* src,
                                                 const Dims& d, int b,
                                                 int c, int h) {
    const int N = d.N;
    if (d.vec) {
        const int N4 = N / 4;
        for (int e = threadIdx.x; e < d.C * N4; e += blockDim.x) {
            const int i = e / N4, q = e % N4;
            cp_async16(dst + i * ld + 4 * q,
                       src + row_off(d, b, c * d.C + i, h) + 4 * q);
        }
    } else {
        for (int e = threadIdx.x; e < d.C * N; e += blockDim.x) {
            const int i = e / N, n = e % N;
            cp_async4(dst + i * ld + n,
                      src + row_off(d, b, c * d.C + i, h) + n);
        }
    }
}

// An (N, N) state block into (N, ld) shared rows, as load_chunk_async.
__device__ __forceinline__ void load_state_async(float* dst, int ld,
                                                 const float* src,
                                                 const Dims& d) {
    const int N = d.N;
    if (d.vec) {
        const int N4 = N / 4;
        for (int e = threadIdx.x; e < N * N4; e += blockDim.x) {
            const int n = e / N4, q = e % N4;
            cp_async16(dst + n * ld + 4 * q, src + n * N + 4 * q);
        }
    } else {
        for (int e = threadIdx.x; e < N * N; e += blockDim.x)
            cp_async4(dst + (e / N) * ld + e % N, src + e);
    }
}

// (a) per (lane, chunk c >= 1): inc_c = r_dec^T dy (N x N) into slot c of
// the scratch buffer, and tot_c = cum_{C-1}.
__global__ void __launch_bounds__(THREADS_B)
wkv_bwd_inc_kernel(const float* __restrict__ r, const float* __restrict__ lw,
                   const float* __restrict__ dy, float* __restrict__ inc,
                   float* __restrict__ tot, Dims d) {
    extern __shared__ __align__(16) float bsm[];
    const int N = d.N, C = d.C;
    const BwdLayout L = bwd_layout(C, N);
    const int PN = L.PN;
    float* Rb = bsm;                  // r, then r_dec = r e^{cp}   (C x PN)
    float* Yb = Rb + L.row;           // dy                         (C x PN)
    float* Lb = Yb + L.row;           // lw, then cum               (C x PN)
    const int per = d.nC - 1;
    const int lane = blockIdx.x / per, c = 1 + blockIdx.x % per;
    const int b = lane / d.H, h = lane % d.H;
    const int tid = threadIdx.x;

    load_chunk_async(Rb, PN, r, d, b, c, h);
    load_chunk_async(Yb, PN, dy, d, b, c, h);
    load_chunk_async(Lb, PN, lw, d, b, c, h);
    cp_async_commit_wait_all();
    __syncthreads();
    if (tid < N) {
        float acc = 0.0f;
        for (int i = 0; i < C; ++i) {
            acc += Lb[i * PN + tid];
            Lb[i * PN + tid] = acc;
        }
        tot[((size_t)lane * d.nC + c) * N + tid] = acc;
    }
    __syncthreads();
    for (int e = tid; e < C * N; e += THREADS_B) {
        const int i = e / N, n = e % N;
        if (i > 0) Rb[i * PN + n] *= decay_exp(Lb[(i - 1) * PN + n]);
    }
    __syncthreads();
    float acc[TPW][4] = {};
    mma_3xtf32(acc, N, C,
               [&](int n, int i) {
                   return n < N && i < C ? Rb[i * PN + n] : 0.0f;
               },
               [&](int i, int m) {
                   return i < C && m < N ? Yb[i * PN + m] : 0.0f;
               });
    float* out = inc + ((size_t)lane * d.nC + c) * N * N;
#pragma unroll
    for (int s = 0; s < TPW; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            int n, m;
            tile_pos(s, e, N, n, m);
            if (n >= 0 && n < N && m < N) out[n * N + m] = acc[s][e];
        }
}

// (b) per (lane, n, m), chunks from the last to the first: slot c's
// increment is read, then replaced by D_c; D_{c-1} = e^{tot_c} D_c + inc_c.
__global__ void __launch_bounds__(THREADS_F)
wkv_bwd_scan_kernel(float* __restrict__ dstates,
                    const float* __restrict__ tot,
                    const float* __restrict__ ds_out, Dims d) {
    const int NN = d.N * d.N;
    const size_t e = (size_t)blockIdx.x * THREADS_F + threadIdx.x;
    if (e >= (size_t)d.B * d.H * NN) return;
    const size_t lane = e / NN;
    const int nm = (int)(e % NN), n = nm / d.N;
    float D = ds_out[lane * NN + nm];
    // 8 chunks' loads in flight at a time, then their steps in order
    for (int c0 = d.nC - 1; c0 >= 0; c0 -= 8) {
        float x[8], dec[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
            if (c0 - q >= 1) {
                const size_t lc = lane * d.nC + c0 - q;
                x[q] = dstates[lc * NN + nm];
                dec[q] = tot[lc * d.N + n];
            }
#pragma unroll
        for (int q = 0; q < 8; ++q)
            if (c0 - q >= 0) {
                dstates[(lane * d.nC + c0 - q) * NN + nm] = D;
                if (c0 - q >= 1) D = expf(dec[q]) * D + x[q];
            }
    }
}

// (c) per (lane, chunk): dr, dk, dv, dlw of the chunk and its du partial,
// from the state at the chunk's start and D_c.
__global__ void __launch_bounds__(THREADS_B, 2)
wkv_bwd_grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u,
                    const float* __restrict__ states,
                    const float* __restrict__ dstates,
                    const float* __restrict__ dy, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dlw, float* __restrict__ du_part,
                    Dims d) {
    extern __shared__ __align__(16) float bsm[];
    const int N = d.N, C = d.C;
    const BwdLayout L = bwd_layout(C, N);
    const int PN = L.PN, PC = L.PC;
    float* Kb = bsm;                  // k, then g, then g's prefix
    float* Vb = Kb + L.row;           // v, then k~, then d(cum)
    float* Yb = Vb + L.row;           // dy, then r^, then d(cp)
    float* Lb = Yb + L.row;           // lw, then cum
    float* Xb = Lb + L.row;           // S_c, then r
    float* Zb = Xb + L.flex;          // D_c, then dA (lower) and A^T (upper)
    float* tt = Zb + L.flex;          // tot = cum_{C-1}     (N)
    float* sds = tt + MAXN;           // sum_m S D           (N)
    float* ddg = sds + MAXN;          // dy_i . v_i          (C)
    float* dg = ddg + MAXC;           // r_i . (u k_i)       (C)
    float* dus = dg + MAXC;           // du partial          (N)
    float* uu = dus + MAXN;           // u of this head      (N)
    float* bg = uu + MAXN;            // sum of g a sub-chunk   (4 x N)
    float* bd = bg + MAXC / SUB * MAXN;   // of d(cum) + d(cp)  (4 x N)
    const int lane = blockIdx.x / d.nC, c = blockIdx.x % d.nC;
    const int b = lane / d.H, h = lane % d.H;
    const int tid = threadIdx.x;
    const int nsub = (C + SUB - 1) / SUB;
    const size_t sc = ((size_t)lane * d.nC + c) * N * N;

    // 1. the chunk's rows, its start state and the gradient after it
    load_chunk_async(Kb, PN, k, d, b, c, h);
    load_chunk_async(Vb, PN, v, d, b, c, h);
    load_chunk_async(Yb, PN, dy, d, b, c, h);
    load_chunk_async(Lb, PN, lw, d, b, c, h);
    load_state_async(Xb, PN, states + sc, d);
    load_state_async(Zb, PN, dstates + sc, d);
    if (tid < N) uu[tid] = u[h * N + tid];
    cp_async_commit_wait_all();
    __syncthreads();
    // 2. cum (as the forward sums it), sum_m S D, and dy_i . v_i
    if (tid < N) {
        float acc = 0.0f;
        for (int i = 0; i < C; ++i) {
            acc += Lb[i * PN + tid];
            Lb[i * PN + tid] = acc;
        }
        tt[tid] = acc;
    } else if (tid < 2 * N) {
        const int n = tid - N;
        float a = 0.0f;
        for (int m = 0; m < N; ++m) a += Xb[n * PN + m] * Zb[n * PN + m];
        sds[n] = a;
    } else if (tid < 2 * N + C) {
        const int i = tid - 2 * N;
        float a = 0.0f;
        for (int m = 0; m < N; ++m) a += Yb[i * PN + m] * Vb[i * PN + m];
        ddg[i] = a;
    }
    __syncthreads();
#define CUM(i, n) Lb[(i) * PN + (n)]
#define CP(i, n) ((i) > 0 ? Lb[((i) - 1) * PN + (n)] : 0.0f)
    // 3. the products that read S_c and D_c, and dA = dy v^T
    float acc1[TPW][4] = {}, acc2[TPW][4] = {}, acc3[TPW][4] = {},
          acc4[TPW][4] = {};
    mma_3xtf32(acc1, C, N,                   // dr_dec = dy S^T
               [&](int i, int m) {
                   return i < C && m < N ? Yb[i * PN + m] : 0.0f;
               },
               [&](int m, int n) {
                   return m < N && n < N ? Xb[n * PN + m] : 0.0f;
               });
    mma_3xtf32(acc2, C, N,                   // dk_dec = v D^T
               [&](int j, int m) {
                   return j < C && m < N ? Vb[j * PN + m] : 0.0f;
               },
               [&](int m, int n) {
                   return m < N && n < N ? Zb[n * PN + m] : 0.0f;
               });
    mma_3xtf32(acc3, C, N,                   // dv so far = k_dec D
               [&](int j, int n) {
                   return j < C && n < N
                       ? Kb[j * PN + n] * decay_exp(tt[n] - CUM(j, n))
                       : 0.0f;
               },
               [&](int n, int m) {
                   return n < N && m < N ? Zb[n * PN + m] : 0.0f;
               });
    mma_3xtf32(acc4, C, N,                   // dA = dy v^T
               [&](int i, int m) {
                   return i < C && m < N ? Yb[i * PN + m] : 0.0f;
               },
               [&](int m, int j) {
                   return m < N && j < C ? Vb[j * PN + m] : 0.0f;
               });
    __syncthreads();
    // 4. r over S_c; dA's strict lower part over D_c; k~ over v (every
    //    sub-chunk but the last, whose k~ no pairwise term reads)
    load_chunk_async(Xb, PN, r, d, b, c, h);
#pragma unroll
    for (int s = 0; s < TPW; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            int i, j;
            tile_pos(s, e, C, i, j);
            if (i >= 0 && i < C && j < i) Zb[i * PC + j] = acc4[s][e];
        }
    for (int e = tid; e < (nsub - 1) * SUB * N; e += THREADS_B) {
        const int j = e / N, n = e % N;
        const int bj = (j / SUB) * SUB + SUB - 1;
        Vb[j * PN + n] = Kb[j * PN + n] * decay_exp(CUM(bj, n) - CUM(j, n));
    }
    cp_async_commit_wait_all();
    __syncthreads();
    // 5. the diagonal bonus, du's partial, and A into the upper triangle
    //    (A_ij at Zb[j][i]): exact on the diagonal sub-blocks, through the
    //    last token b of j's sub-chunk off them
    if (tid < C) {
        float a = 0.0f;
        for (int n = 0; n < N; ++n)
            a += Xb[tid * PN + n] * (Kb[tid * PN + n] * uu[n]);
        dg[tid] = a;
    } else if (tid < C + N) {
        const int n = tid - C;
        float a = 0.0f;
        for (int i = 0; i < C; ++i)
            a += ddg[i] * (Xb[i * PN + n] * Kb[i * PN + n]);
        dus[n] = a;
    }
    int pairs = 0;
    for (int I = 0; I < nsub; ++I) {
        const int Ls = min(SUB, C - I * SUB);
        pairs += Ls * (Ls - 1) / 2;
    }
    for (int p = tid; p < pairs; p += THREADS_B) {
        int q = p, I = 0;
        for (;; ++I) {
            const int Ls = min(SUB, C - I * SUB);
            if (q < Ls * (Ls - 1) / 2) break;
            q -= Ls * (Ls - 1) / 2;
        }
        int ai = 1;
        while (q >= ai) {
            q -= ai;
            ++ai;
        }
        const int i = I * SUB + ai, j = I * SUB + q;
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // four chains in flight
        int n = 0;
        for (; n + 4 <= N; n += 4)
#pragma unroll
            for (int z = 0; z < 4; ++z)
                a[z] += Xb[i * PN + n + z] * Kb[j * PN + n + z]
                        * decay_exp(CP(i, n + z) - CUM(j, n + z));
        for (; n < N; ++n)
            a[0] += Xb[i * PN + n] * Kb[j * PN + n]
                    * decay_exp(CP(i, n) - CUM(j, n));
        Zb[j * PC + i] = (a[0] + a[1]) + (a[2] + a[3]);
    }
    // the off-diagonal sub-blocks as 3xTF32 products, a 16 x 8 tile (i in
    // sub-chunk I, 8 columns of an earlier J) a warp at a time:
    // (r e^{cp - cum_b}) (k~)^T, b the last token of J
    const int warp = tid >> 5;
    int tiles = 0;
    for (int I = 1; I < nsub; ++I) tiles += 2 * I;
    for (int tl = warp; tl < tiles; tl += THREADS_B / 32) {
        int q = tl, I = 1;
        while (q >= 2 * I) {
            q -= 2 * I;
            ++I;
        }
        const int J = q >> 1, r0 = I * SUB, c0 = J * SUB + 8 * (q & 1);
        const int bj = J * SUB + SUB - 1;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tile_3xtf32(acc, r0, c0, N,
                        [&](int i, int n) {
                            return i < C && n < N
                                ? Xb[i * PN + n]
                                  * decay_exp(CP(i, n) - CUM(bj, n))
                                : 0.0f;
                        },
                        [&](int n, int j) {
                            return n < N ? Vb[j * PN + n] : 0.0f;
                        });
        const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = r0 + g + 8 * (e >> 1), j = c0 + 2 * t + (e & 1);
            if (i < C) Zb[j * PC + i] = acc[e];
        }
    }
    __syncthreads();
    // 6. dv = k_dec D + A^T dy + dg dy
    mma_3xtf32(acc3, C, C,
               [&](int j, int i) {
                   return j < C && i < C && i > j ? Zb[j * PC + i] : 0.0f;
               },
               [&](int i, int m) {
                   return i < C && m < N ? Yb[i * PN + m] : 0.0f;
               });
#pragma unroll
    for (int s = 0; s < TPW; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            int j, m;
            tile_pos(s, e, C, j, m);
            if (j >= 0 && j < C && m < N)
                dv[row_off(d, b, c * C + j, h) + m] =
                    acc3[s][e] + dg[j] * Yb[j * PN + m];
        }
    __syncthreads();
    // 7. dr_dec and dk_dec over dy and k~ (both done with)
#pragma unroll
    for (int s = 0; s < TPW; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            int i, n;
            tile_pos(s, e, C, i, n);
            if (i >= 0 && i < C && n < N) {
                Yb[i * PN + n] = acc1[s][e];
                Vb[i * PN + n] = acc2[s][e];
            }
        }
    __syncthreads();
    // 8. a thread per (sub-chunk I, channel n), its rows' sums in
    //    registers: pv_i = sum_{j<i} dA_ij k_j e^{cp_i - cum_j} and qv_j =
    //    sum_{i>j} dA_ij r_i e^{cp_i - cum_j}, exact within the sub-chunk;
    //    across sub-chunks pv through k~ = k e^{cum_b - cum} (b the last
    //    token of j's sub-chunk) and qv through r^ = r e^{cp - cp_a} (a
    //    the first token of i's), both formed here.  The j = i - 1 terms
    //    (decay exactly 1) stay out of pv and qv: tv and sv carry them to
    //    dr and dk.
    const int I = tid / N, n = tid % N;
    const bool mine = I < nsub;
    const int i0 = I * SUB, LI = mine ? min(SUB, C - i0) : 0;
    float pv[SUB], qv[SUB], gg[SUB];
#pragma unroll
    for (int ii = 0; ii < SUB; ++ii) pv[ii] = qv[ii] = gg[ii] = 0.0f;
#pragma unroll
    for (int ii = 2; ii < SUB; ++ii) {
        if (ii >= LI) break;
        const int i = i0 + ii;
        const float cpi = CUM(i - 1, n), ri = Xb[i * PN + n];
#pragma unroll
        for (int jj = 0; jj < ii - 1; ++jj) {
            const int j = i0 + jj;
            const float E = decay_exp(cpi - CUM(j, n));
            const float da = Zb[i * PC + j];
            pv[ii] += da * Kb[j * PN + n] * E;
            qv[jj] += da * ri * E;
        }
    }
    for (int J = 0; J < I && mine; ++J) {
        const int j0 = J * SUB;
        const float cb = CUM(j0 + SUB - 1, n);
        float kt[SUB];
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj)
            kt[jj] = Kb[(j0 + jj) * PN + n] * decay_exp(cb - CUM(j0 + jj, n));
        const float kb = kt[SUB - 1];
        if (J == I - 1) kt[SUB - 1] = 0.0f;   // row i0 leaves j = i0 - 1 out
#pragma unroll
        for (int ii = 0; ii < SUB; ++ii) {
            if (ii >= LI) break;
            const float4* z = reinterpret_cast<const float4*>(
                Zb + (i0 + ii) * PC + j0);
            float t = 0.0f;
#pragma unroll
            for (int q = 0; q < SUB / 4; ++q) {
                const float4 x = z[q];
                t += x.x * kt[4 * q] + x.y * kt[4 * q + 1]
                     + x.z * kt[4 * q + 2] + x.w * kt[4 * q + 3];
            }
            pv[ii] += decay_exp(CP(i0 + ii, n) - cb) * t;
            if (ii == 0) kt[SUB - 1] = kb;
        }
    }
    for (int I2 = I + 1; I2 < nsub && mine; ++I2) {
        const int a0 = I2 * SUB, L2 = min(SUB, C - a0);
        const float ca = CUM(a0 - 1, n);
        float tq[SUB];
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) tq[jj] = 0.0f;
        for (int ll = 0; ll < L2; ++ll) {
            const float rh = Xb[(a0 + ll) * PN + n]
                             * decay_exp(CP(a0 + ll, n) - ca);
            const float4* z = reinterpret_cast<const float4*>(
                Zb + (a0 + ll) * PC + i0);
#pragma unroll
            for (int q = 0; q < SUB / 4; ++q) {
                const float4 x = z[q];
                tq[4 * q] += x.x * rh;
                tq[4 * q + 1] += x.y * rh;
                tq[4 * q + 2] += x.z * rh;
                // row a0 leaves j = a0 - 1 (the last of I) out
                if (q < SUB / 4 - 1 || ll > 0 || I2 > I + 1)
                    tq[4 * q + 3] += x.w * rh;
            }
        }
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj)
            qv[jj] += decay_exp(ca - CUM(i0 + jj, n)) * tq[jj];
    }
    // the rows' gradients: dr and dk to device memory; g = dk_dec k_dec
    // into gg, d(cp) into pv, d(cum) less g into qv
    const float un = mine ? uu[n] : 0.0f, tn = mine ? tt[n] : 0.0f;
    float gsum = 0.0f, dsum = 0.0f;
#pragma unroll
    for (int ii = 0; ii < SUB; ++ii) {
        if (ii >= LI) break;
        const int i = i0 + ii;
        const float ri = Xb[i * PN + n], ki = Kb[i * PN + n];
        const float tv = i > 0 ? Zb[i * PC + i - 1] * Kb[(i - 1) * PN + n]
                               : 0.0f;
        const float sv = i + 1 < C ? Zb[(i + 1) * PC + i]
                                     * Xb[(i + 1) * PN + n]
                                   : 0.0f;
        const float drd = Yb[i * PN + n], dkd = Vb[i * PN + n];
        const float ecp = decay_exp(CP(i, n));
        const float ek = decay_exp(tn - CUM(i, n));
        const float ud = ddg[i] * un;
        const size_t o = row_off(d, b, c * C + i, h) + n;
        dr[o] = drd * ecp + (pv[ii] + tv) + ud * ki;
        dk[o] = dkd * ek + (qv[ii] + sv) + ud * ri;
        gg[ii] = dkd * (ki * ek);
        pv[ii] = drd * (ri * ecp) + ri * pv[ii];
        qv[ii] = -ki * qv[ii];
        gsum += gg[ii];
        dsum += qv[ii] + pv[ii];
    }
    // 9. dlw_i = e^{tot} sum_m S D + sum_{j<i} g_j + sum_{i'>=i} d(cum)_{i'}
    //    + sum_{i'>i} d(cp)_{i'} (cp_{i'} = cum_{i'-1}; d(tot) = sum_j g_j +
    //    e^{tot} sum_m S D, and g_j also leaves d(cum_j)): each thread's
    //    sums over its sub-chunk, then the other sub-chunks' totals, in
    //    order
    if (mine) {
        bg[I * MAXN + n] = gsum;
        bd[I * MAXN + n] = dsum;
    }
    __syncthreads();
    if (mine) {
        float P = 0.0f, Q = 0.0f;
        for (int J = 0; J < I; ++J) P += bg[J * MAXN + n];
        for (int J = nsub - 1; J > I; --J) Q += bd[J * MAXN + n];
        const float es = sds[n] * decay_exp(tn);
#pragma unroll
        for (int ii = 0; ii < SUB; ++ii)
            if (ii < LI) {
                const float gi = gg[ii];
                gg[ii] = P;                     // sum_{j<i} g_j
                P += gi;
            }
#pragma unroll
        for (int ii = SUB - 1; ii >= 0; --ii)
            if (ii < LI) {
                Q += qv[ii];
                dlw[row_off(d, b, c * C + i0 + ii, h) + n] = (es + gg[ii]) + Q;
                Q += pv[ii];
            }
    }
    if (tid < N) du_part[((size_t)lane * d.nC + c) * N + tid] = dus[tid];
#undef CP
#undef CUM
}

size_t chunk_smem(int C, int N) {
    return sizeof(float) * 3 * C * (N + 1);
}

size_t out_smem(int C, int N) {
    return sizeof(float) * (4 * C * (N + 1) + N * (N + 1) + C * (C + 1) + C);
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

// The backward's three launches in order on ``stream`` (the first only
// when there is more than one chunk); returns the first launch error.
// dstates (B H, S/C, N, N) and tot (B H, S/C, N) are scratch, written
// before they are read; du_part (B H, S/C, N) gets one du partial a
// (lane, chunk).
extern "C" int rwkv6_wkv_bwd_launch(const float* r, const float* k,
                                    const float* v, const float* lw,
                                    const float* u, const float* states,
                                    const float* dy, const float* ds_out,
                                    float* dr, float* dk, float* dv,
                                    float* dlw, float* du_part,
                                    float* dstates, float* tot, int B,
                                    int S, int H, int N, int C,
                                    void* stream) {
    if (N < 1 || N > MAXN || C < 1 || C > MAXC || S % C != 0)
        return (int)cudaErrorInvalidValue;
    const int vec = N % 4 == 0 && aligned16(r) && aligned16(k)
                    && aligned16(v) && aligned16(lw) && aligned16(dy)
                    && aligned16(states) && aligned16(dstates);
    const Dims d{B, S, H, N, C, S / C, vec};
    cudaStream_t st = (cudaStream_t)stream;
    const BwdLayout L = bwd_layout(C, N);
    const size_t sm_a = sizeof(float) * 3 * L.row;
    const size_t sm_c = sizeof(float)
                        * (4 * L.row + 2 * L.flex + 4 * MAXN + 2 * MAXC
                           + 2 * MAXC / SUB * MAXN);
    cudaError_t err;
    if (d.nC > 1) {
        err = cudaFuncSetAttribute(
            wkv_bwd_inc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)sm_a);
        if (err != cudaSuccess) return (int)err;
        wkv_bwd_inc_kernel<<<B * H * (d.nC - 1), THREADS_B, sm_a, st>>>(
            r, lw, dy, dstates, tot, d);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const size_t entries = (size_t)B * H * N * N;
    wkv_bwd_scan_kernel<<<(unsigned)((entries + THREADS_F - 1) / THREADS_F),
                          THREADS_F, 0, st>>>(dstates, tot, ds_out, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        wkv_bwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm_c);
    if (err != cudaSuccess) return (int)err;
    wkv_bwd_grad_kernel<<<B * H * d.nC, THREADS_B, sm_c, st>>>(
        r, k, v, lw, u, states, dstates, dy, dr, dk, dv, dlw, du_part, d);
    return (int)cudaGetLastError();
}
