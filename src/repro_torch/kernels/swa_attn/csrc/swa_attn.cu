// Causal sliding-window attention, forward, for Hopper (sm_90a); bf16 or
// fp32 in and out, fp32 arithmetic throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attn/kernel.py
// (swa_attn, body _swa_kernel), the TPU version of the band attention
// the reference's models run in XLA (models/attention.py:_mha_band).
// Query s attends to the keys in (s - window, s]:
//
//   o_s = sum_j softmax_j(scale * q_s . k_j) v_j,   s - window < j <= s
//
// with an online softmax (m, l, acc) over the key tiles, every product
// and sum in fp32 (as swa_attn_ref: p stays fp32 for p . v), and the
// output written as acc / max(l, 1e-30) in q's dtype.
//
// Layout: the port's, read in place.  q and o are (B, S, KV, G, hd), k
// and v (B, S, KV, hd); head h = kv * G + g reads its KV group's k and v
// without a repeat.  An optional lengths (B,) int32 marks row b's tokens
// at or past lengths[b] invalid: those keys are masked and those query
// rows are written as zeros.
//
// What bounds it on this card: operations.  At the serving path's
// prefill shape (B 1, S 8192, 24 heads of 128, window 4096) the band
// holds 25.2M (query, key) pairs a head, 4 hd FLOP a pair, 309 GFLOP in
// all, against ~0.1 GB of bf16 q, k, v and o: thousands of FLOPs a
// byte, far above the ridge of either the fp32 or the bf16 rate.  This
// is the simple first version: fp32 SIMT FMAs, no tensor cores, no
// wgmma or TMA, no overlap of loads with compute (later work).
//
// Design: one block of 256 threads per (q tile of 64 rows, head,
// batch), looping over the 64-key tiles the window reaches from that q
// tile (65 at window 4096, fewer at the start of the sequence).  The q
// tile is staged once in shared memory, transposed and converted to
// fp32; each k tile is staged the same way, then each v tile into the
// same buffer.  Thread (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty
// + 3 and, for the scores, key columns 4 tx .. 4 tx + 3 (float4 reads of
// both transposed tiles), for p . v the hd / 16 output columns tx + 16 c.
// Each row's max and the rescale factor are reduced over its 16 threads
// with shuffles; the masks (the window's two edges, the ragged S and
// window edges, the per-row lengths) are applied per element, and a
// masked entry contributes exactly 0 (never exp(-1e30 - m)).  Sums run
// in a fixed order and there are no atomics, so two launches on the
// same inputs agree bit for bit.  Shared memory at hd 128 is 87 KB, two
// blocks an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define TQ 64
#define TK 64
#define THREADS 256
#define LDT (TQ + 4)        // row pitch of the transposed tiles (floats)

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

constexpr float NEG = -1e30f;

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
swa_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ lengths,
                T* __restrict__ o, int S, int KV, int G, int window,
                float scale) {
    constexpr int DPT = HD / 16;            // p . v output columns a thread
    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;                       // [HD][LDT]   q tile, transposed
    float* KVs = Qt + HD * LDT;             // [HD][LDT] k tile, transposed,
                                            // then [TK][HD] v tile
    float* Pt = KVs + HD * LDT;             // [TK][LDT]   p tile, transposed

    const int q0 = blockIdx.x * TQ;
    const int head = blockIdx.y;
    const int b = blockIdx.z;
    const int kv = head / G;
    const int H = KV * G;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int n = lengths ? min(lengths[b], S) : S;

    const size_t q_row = (size_t)H * HD;    // stride of s in q and o
    const size_t k_row = (size_t)KV * HD;   // stride of s in k and v
    const T* qb = q + (size_t)b * S * q_row + (size_t)head * HD;
    T* ob = o + (size_t)b * S * q_row + (size_t)head * HD;
    const T* kb = k + (size_t)b * S * k_row + (size_t)kv * HD;
    const T* vb = v + (size_t)b * S * k_row + (size_t)kv * HD;

    float acc[4][DPT];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;
    }

    if (q0 < n) {
        for (int e = tid; e < TQ * HD; e += THREADS) {
            const int r = e / HD, d = e % HD;
            const int s = q0 + r;
            Qt[d * LDT + r] = s < S ? to_f(qb[(size_t)s * q_row + d]) : 0.0f;
        }
        const int q_last = min(q0 + TQ, n) - 1;
        const int kt_lo = max(0, q0 - window + 1) / TK;
        const int kt_hi = q_last / TK;
        for (int kt = kt_lo; kt <= kt_hi; ++kt) {
            const int k0 = kt * TK;
            __syncthreads();                // previous tile's v reads done
            for (int e = tid; e < TK * HD; e += THREADS) {
                const int r = e / HD, d = e % HD;
                const int s = k0 + r;
                KVs[d * LDT + r] =
                    s < S ? to_f(kb[(size_t)s * k_row + d]) : 0.0f;
            }
            __syncthreads();

            float sc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) {
                const float4 a = *reinterpret_cast<const float4*>(
                    &Qt[d * LDT + ty * 4]);
                const float4 bb = *reinterpret_cast<const float4*>(
                    &KVs[d * LDT + tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
            }

            // mask, online softmax; p tile to shared memory (transposed)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int qp = q0 + ty * 4 + i;
                bool ok[4];
                float mx = NEG;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int kp = k0 + tx * 4 + j;
                    ok[j] = qp < n && kp < n && kp <= qp
                            && qp - kp < window;
                    sc[i][j] *= scale;
                    if (ok[j]) mx = fmaxf(mx, sc[i][j]);
                }
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
                const float m_new = fmaxf(m[i], mx);
                const float alpha = expf(m[i] - m_new);
                m[i] = m_new;
                float rs = 0.0f;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
                    sc[i][j] = p;
                    rs += p;
                }
                l[i] = l[i] * alpha + rs;   // this thread's columns only
#pragma unroll
                for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDT + ty * 4]) =
                    make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
            __syncthreads();                // k reads and p writes done

            for (int e = tid; e < TK * HD; e += THREADS) {
                const int r = e / HD, d = e % HD;
                const int s = k0 + r;
                KVs[r * HD + d] =
                    s < S ? to_f(vb[(size_t)s * k_row + d]) : 0.0f;
            }
            __syncthreads();
#pragma unroll 4
            for (int j = 0; j < TK; ++j) {
                const float4 a = *reinterpret_cast<const float4*>(
                    &Pt[j * LDT + ty * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                for (int c = 0; c < DPT; ++c) {
                    const float vv = KVs[j * HD + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][c] = fmaf(av[i], vv, acc[i][c]);
                }
            }
        }
    }

    // each row's l is the sum of its 16 threads' partial sums
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float li = l[i];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            li += __shfl_xor_sync(0xffffffffu, li, off);
        const int s = q0 + ty * 4 + i;
        if (s >= S) continue;
        const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
        for (int c = 0; c < DPT; ++c)
            store(&ob[(size_t)s * q_row + tx + 16 * c], acc[i][c] * inv);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int B, int S, int KV, int G, int window, float scale,
           cudaStream_t stream) {
    const int smem = (2 * HD * LDT + TK * LDT) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        swa_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + TQ - 1) / TQ, KV * G, B);
    swa_attn_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, S, KV, G,
        window, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* lengths, void* o, int B, int S, int KV, int G,
                int window, float scale, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, lengths, o, B, S, KV, G,
                                      window, scale, stream);
        case 32: return launch<T, 32>(q, k, v, lengths, o, B, S, KV, G,
                                      window, scale, stream);
        case 64: return launch<T, 64>(q, k, v, lengths, o, B, S, KV, G,
                                      window, scale, stream);
        case 128: return launch<T, 128>(q, k, v, lengths, o, B, S, KV, G,
                                        window, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype 0: fp32, 1: bf16.  lengths may be null (every row holds S).
extern "C" int swa_attn_launch(const void* q, const void* k, const void* v,
                               const int* lengths, void* o, int B, int S,
                               int KV, int G, int hd, int window, float scale,
                               int dtype, void* stream) {
    if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || window <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, lengths, o, B, S, KV, G,
                                  window, scale, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, lengths, o, B, S, KV,
                                          G, window, scale, st);
    return (int)cudaErrorInvalidValue;
}
