// Causal sliding-window attention, backward, for Hopper (sm_90a): dq, dk
// and dv of the forward in swa_attn.cu, from its output and the lse it
// writes when autograd needs it.  bf16 or fp32 in and out.
//
// No TPU kernel matches it: the reference trains through jax.grad of its
// XLA band gather (src/repro/models/attention.py:_mha_band).  Layout, the
// band and the lengths are the forward's (its source has the details):
// q, dq and dout (B, S, KV, G, hd), k, v, dk and dv (B, S, KV, hd), out
// like q, lse (B, S, KV, G) fp32.
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define THREADS 256

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) fp32 -> hi = bf16(x, y) and lo = bf16(x - hi, y - hi), x in the
// low half (the smaller index of an mma fragment pair)
__device__ __forceinline__ void split_p(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    hi = bf16x2_bits(h);
    lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// ---- backward: fp32 SIMT (fp32 inputs, and bf16 at head dim 256) -------
//
// The gradient of the forward above (p kept fp32 for p . v), from its
// output o and each row's lse = m + log l (natural units) that the forward
// wrote:
//
//   p_sj = exp(scale q_s . k_j - lse_s)        (0 outside the band)
//   dp_sj = dout_s . v_j,   D_s = dout_s . o_s,   ds_sj = p_sj (dp_sj - D_s)
//   dq_s = scale sum_j ds_sj k_j,   dk_j = scale sum_s ds_sj q_s,
//   dv_j = sum_s p_sj dout_s
//
// where s runs over the G query heads of k_j's KV head as well.  Rows at or
// past a row's length have p = 0 (their output is the zero the forward
// wrote), so they give nothing, and keys at or past it get zero dk / dv.
// Three launches: D (one warp a row), dq (one block per q tile and query
// head, over the key tiles the tile's band reaches) and dk / dv (one block
// per key tile and KV head, over the G heads and the q tiles whose band
// reaches the tile).  Each output element is summed by one thread in a
// fixed order: no atomics, so two launches agree bit for bit.  bf16
// inputs at head dims up to 128 take the tensor-core body further down,
// with the same blocks and order.
//
// What bounds it: operations, 10 hd FLOP a (query, key) pair and query
// head (s, dp, dq, dk, dv; both bodies recompute s and dp in the dq and
// the dk / dv kernels, 14 hd).  At starcoder2-3b's training shape (B 2,
// S 8,192, 24 heads of 128, window 4,096) that is 1,546 GFLOP, 1.56 ms
// at the bf16 tensor-core peak and 23.1 ms at the fp32 peak.
//
// Both product kernels share one shape: a block of 256 threads (16 x 16)
// holds a resident tile of TR rows (q and dout for dq; k and v for dk / dv)
// and streams tiles of TC = 64 columns (k and v; q and dout), every tile
// transposed in shared memory as fp32 ([hd][rows + 4]) whatever the input
// dtype.  Thread (ty, tx) computes the scores and dp of rows RI ty .. RI ty
// + RI - 1 and columns 4 tx .. 4 tx + 3 with fp32 FMAs, then accumulates
// its rows' output columns tx + 16 c.  TR is 64, but 32 at head dim 256,
// where four 64-row tiles of fp32 would not fit in shared memory.

constexpr int BTC = 64;                   // streamed columns a tile
constexpr int BLDC = BTC + 4;

template <int HD>
struct BwdTile {
    static constexpr int TR = HD > 128 ? 32 : 64;
    static constexpr int RI = TR / 16;
    static constexpr int LDR = TR + 4;
    static constexpr int DPT = HD / 16;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
    return __float2bfloat16_rn(x);
}

template <int R>
__device__ __forceinline__ void lds(const float* p, float (&out)[R]) {
    if constexpr (R == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    } else {
        const float2 t = *reinterpret_cast<const float2*>(p);
        out[0] = t.x; out[1] = t.y;
    }
}

// rows r0 .. r0 + rows - 1 of one head of a (B, S, heads, HD) tensor ->
// shared [HD][ld] fp32, transposed; rows past S as zeros
template <int HD, typename T>
__device__ __forceinline__ void load_t(float* dst, int ld, const T* base,
                                       size_t row_stride, int r0, int rows,
                                       int S) {
    for (int e = threadIdx.x; e < rows * HD; e += THREADS) {
        const int r = e / HD, d = e % HD;
        const int s = r0 + r;
        dst[d * ld + r] = s < S ? to_f32(base[(size_t)s * row_stride + d])
                                : 0.0f;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
swa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     const int* __restrict__ lengths,
                     float* __restrict__ delta, int S, int H, int hd,
                     long long n_rows) {
    const long long row = (long long)blockIdx.x * (THREADS / 32)
                          + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= n_rows) return;
    const int b = (int)(row / ((long long)S * H));
    const int s = (int)((row / H) % S);
    const int n = lengths ? min(lengths[b], S) : S;
    float acc = 0.0f;
    if (s < n)
        for (int d = lane; d < hd; d += 32)
            acc = fmaf(to_f32(o[row * hd + d]), to_f32(dout[row * hd + d]),
                       acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row] = acc;
}

// scores and dp of a thread's RI x 4 block: s = A1 . B1, dp = A2 . B2 over
// the head dim, A* [HD][LDR] (rows), B* [HD][BLDC] (columns)
template <int HD, int RI, int LDR>
__device__ __forceinline__ void bwd_scores(const float* A1, const float* B1,
                                           const float* A2, const float* B2,
                                           int ty, int tx, float (&sc)[RI][4],
                                           float (&dp)[RI][4]) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
        float a1[RI], a2[RI], b1[4], b2[4];
        lds<RI>(&A1[d * LDR + ty * RI], a1);
        lds<4>(&B1[d * BLDC + tx * 4], b1);
        lds<RI>(&A2[d * LDR + ty * RI], a2);
        lds<4>(&B2[d * BLDC + tx * 4], b2);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                sc[i][j] = fmaf(a1[i], b1[j], sc[i][j]);
                dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
            }
    }
}

// dq: one block per (q tile of TR rows, query head, batch)
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ lengths, T* __restrict__ dq, int S,
                  int KV, int G, int window, float scale) {
    constexpr int TR = BwdTile<HD>::TR, RI = BwdTile<HD>::RI;
    constexpr int LDR = BwdTile<HD>::LDR, DPT = BwdTile<HD>::DPT;
    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;                       // [HD][LDR]
    float* dOt = Qt + HD * LDR;             // [HD][LDR]
    float* Kt = dOt + HD * LDR;             // [HD][BLDC]
    float* Vt = Kt + HD * BLDC;             // [HD][BLDC]
    float* dSt = Vt + HD * BLDC;            // [BTC][LDR]

    const int q0 = blockIdx.x * TR;
    const int head = blockIdx.y;
    const int b = blockIdx.z;
    const int kv = head / G;
    const int H = KV * G;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int n = lengths ? min(lengths[b], S) : S;
    const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
    const size_t qoff = (size_t)b * S * q_row + (size_t)head * HD;
    const size_t koff = (size_t)b * S * k_row + (size_t)kv * HD;

    float acc[RI][DPT];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;

    if (q0 < n) {
        float row_lse[RI], row_d[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const int s = min(q0 + ty * RI + i, S - 1);
            row_lse[i] = lse[((size_t)b * S + s) * H + head];
            row_d[i] = delta[((size_t)b * S + s) * H + head];
        }
        load_t<HD>(Qt, LDR, q + qoff, q_row, q0, TR, S);
        load_t<HD>(dOt, LDR, dout + qoff, q_row, q0, TR, S);
        const int q_last = min(q0 + TR, n) - 1;
        const int kt_lo = max(0, q0 - window + 1) / BTC;
        const int kt_hi = q_last / BTC;
        for (int kt = kt_lo; kt <= kt_hi; ++kt) {
            const int k0 = kt * BTC;
            __syncthreads();                // the last tile's reads done
            load_t<HD>(Kt, BLDC, k + koff, k_row, k0, BTC, S);
            load_t<HD>(Vt, BLDC, v + koff, k_row, k0, BTC, S);
            __syncthreads();
            float sc[RI][4], dp[RI][4];
            bwd_scores<HD, RI, LDR>(Qt, Kt, dOt, Vt, ty, tx, sc, dp);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
                const int qp = q0 + ty * RI + i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int kp = k0 + tx * 4 + j;
                    const bool ok = qp < n && kp < n && kp <= qp
                                    && qp - kp < window;
                    const float p = ok ? expf(sc[i][j] * scale - row_lse[i])
                                       : 0.0f;
                    dSt[(tx * 4 + j) * LDR + ty * RI + i] =
                        p * (dp[i][j] - row_d[i]);
                }
            }
            __syncthreads();
#pragma unroll 4
            for (int c = 0; c < BTC; ++c) {
                float a[RI];
                lds<RI>(&dSt[c * LDR + ty * RI], a);
#pragma unroll
                for (int col = 0; col < DPT; ++col) {
                    const float kk = Kt[(tx + 16 * col) * BLDC + c];
#pragma unroll
                    for (int i = 0; i < RI; ++i)
                        acc[i][col] = fmaf(a[i], kk, acc[i][col]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int s = q0 + ty * RI + i;
        if (s >= S) continue;
#pragma unroll
        for (int col = 0; col < DPT; ++col)
            dq[qoff + (size_t)s * q_row + tx + 16 * col] =
                from_f32<T>(acc[i][col] * scale);
    }
}

// dk and dv: one block per (key tile of TR keys, KV head, batch), over the G
// query heads of the KV head and the q tiles whose band reaches the tile
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
swa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lengths, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int KV, int G, int window,
                    float scale) {
    constexpr int TR = BwdTile<HD>::TR, RI = BwdTile<HD>::RI;
    constexpr int LDR = BwdTile<HD>::LDR, DPT = BwdTile<HD>::DPT;
    extern __shared__ __align__(16) float smem[];
    float* Kt = smem;                       // [HD][LDR]
    float* Vt = Kt + HD * LDR;              // [HD][LDR]
    float* Qt = Vt + HD * LDR;              // [HD][BLDC]
    float* dOt = Qt + HD * BLDC;            // [HD][BLDC]
    float* Pt = dOt + HD * BLDC;            // [BTC][LDR]  p, [q][key]
    float* dSt = Pt + BTC * LDR;            // [BTC][LDR]  ds, [q][key]
    float* cL = dSt + BTC * LDR;            // [BTC] the columns' lse
    float* cD = cL + BTC;                   // [BTC] the columns' D

    const int k0 = blockIdx.x * TR;
    const int kv = blockIdx.y;
    const int b = blockIdx.z;
    const int H = KV * G;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int n = lengths ? min(lengths[b], S) : S;
    const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
    const size_t koff = (size_t)b * S * k_row + (size_t)kv * HD;

    float acc_k[RI][DPT], acc_v[RI][DPT];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

    if (k0 < n) {
        load_t<HD>(Kt, LDR, k + koff, k_row, k0, TR, S);
        load_t<HD>(Vt, LDR, v + koff, k_row, k0, TR, S);
        const int q_hi = min(k0 + TR - 1 + window - 1, n - 1);
        const int qt_lo = k0 / BTC, qt_hi = q_hi / BTC;
        for (int g = 0; g < G; ++g) {
            const int head = kv * G + g;
            const size_t qoff = (size_t)b * S * q_row + (size_t)head * HD;
            for (int qt = qt_lo; qt <= qt_hi; ++qt) {
                const int q0 = qt * BTC;
                __syncthreads();            // the last tile's reads done
                load_t<HD>(Qt, BLDC, q + qoff, q_row, q0, BTC, S);
                load_t<HD>(dOt, BLDC, dout + qoff, q_row, q0, BTC, S);
                for (int c = threadIdx.x; c < BTC; c += THREADS) {
                    const int s = min(q0 + c, S - 1);
                    cL[c] = lse[((size_t)b * S + s) * H + head];
                    cD[c] = delta[((size_t)b * S + s) * H + head];
                }
                __syncthreads();
                float sc[RI][4], dp[RI][4];
                bwd_scores<HD, RI, LDR>(Kt, Qt, Vt, dOt, ty, tx, sc, dp);
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    const int kp = k0 + ty * RI + i;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int c = tx * 4 + j;
                        const int qp = q0 + c;
                        const bool ok = qp < n && kp < n && kp <= qp
                                        && qp - kp < window;
                        const float p = ok ? expf(sc[i][j] * scale - cL[c])
                                           : 0.0f;
                        Pt[c * LDR + ty * RI + i] = p;
                        dSt[c * LDR + ty * RI + i] = p * (dp[i][j] - cD[c]);
                    }
                }
                __syncthreads();
#pragma unroll 2
                for (int c = 0; c < BTC; ++c) {
                    float ap[RI], as[RI];
                    lds<RI>(&Pt[c * LDR + ty * RI], ap);
                    lds<RI>(&dSt[c * LDR + ty * RI], as);
#pragma unroll
                    for (int col = 0; col < DPT; ++col) {
                        const float dov = dOt[(tx + 16 * col) * BLDC + c];
                        const float qv = Qt[(tx + 16 * col) * BLDC + c];
#pragma unroll
                        for (int i = 0; i < RI; ++i) {
                            acc_v[i][col] = fmaf(ap[i], dov, acc_v[i][col]);
                            acc_k[i][col] = fmaf(as[i], qv, acc_k[i][col]);
                        }
                    }
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int s = k0 + ty * RI + i;
        if (s >= S) continue;
#pragma unroll
        for (int col = 0; col < DPT; ++col) {
            const size_t at = koff + (size_t)s * k_row + tx + 16 * col;
            dk[at] = from_f32<T>(acc_k[i][col] * scale);
            dv[at] = from_f32<T>(acc_v[i][col]);
        }
    }
}

// ---- backward, bf16 at head dims up to 128: mma.sync on the tensor cores
//
// The same three steps and the same blocks of 64 rows as the SIMT body,
// in four warps of 16 rows each; the products run as mma.sync m16n8k16
// (bf16 in, fp32 accumulate).  q, k, v and dout are bf16 already, so
// s = q k^T and dp = dout v^T are exact products summed in fp32.  p and
// ds are fp32: as the forward's p . v, each is split into bf16 hi =
// bf16(x) and lo = bf16(x - hi) and multiplied twice, leaving ~2^-17
// relative error in each term.  The accumulators of s and dp are the A
// operands of the next products in registers (two n8 tiles of a C
// fragment are one k16 tile of an A fragment).  dq, dk and dv sum each
// 64-row tile's products on the tensor cores from zero and add that to
// their fp32 accumulators with ordinary adds: one chain of tensor-core
// accumulation over the whole band (up to 4,096 keys x 12 heads) put dk
// up to 1.27e-5 of its largest entry from the plain backward on an H100,
// against 1e-5 for the fp32 SIMT body.  Tiles live in shared
// memory as bf16, row-major (pitch hd + 8) for the operands whose
// reduction runs over hd, and transposed (pitch 72) for those whose
// reduction runs over the tile's rows; both pitches put a warp's 32-bit
// fragment loads in 32 distinct banks.  At head dim 256 the dk / dv
// accumulators alone would take 256 registers a thread: that head dim
// takes the SIMT body.

constexpr int TC_ROWS = 64;               // rows a block (4 warps x 16)
constexpr int TC_THREADS_B = 128;
constexpr int TPT = TC_ROWS + 8;          // pitch of a transposed tile

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16) at rows r0.., k0.. of a row-major tile of pitch P
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int P,
                                       int r0, int k0, int g, int q4) {
    a[0] = lds32(t + (r0 + g) * P + k0 + 2 * q4);
    a[1] = lds32(t + (r0 + g + 8) * P + k0 + 2 * q4);
    a[2] = lds32(t + (r0 + g) * P + k0 + 8 + 2 * q4);
    a[3] = lds32(t + (r0 + g + 8) * P + k0 + 8 + 2 * q4);
}

// B fragment (16 x 8) of B[k][n] stored n-major (t[n][k], pitch P)
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* t, int P, int n0, int k0,
                                       int g, int q4) {
    b0 = lds32(t + (n0 + g) * P + k0 + 2 * q4);
    b1 = lds32(t + (n0 + g) * P + k0 + 8 + 2 * q4);
}

// the k16 A fragments (hi, lo) of columns 16 kk .. 16 kk + 15 of a 16 x 64
// fp32 tile held as C fragments x[8][4]
__device__ __forceinline__ void frag_split(const float (&x)[8][4], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
    split_p(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_p(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_p(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_p(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// rows r0 .. r0 + 63 of one head of a (B, S, heads, HD) bf16 tensor ->
// shared row-major [64][HD + 8] and, when tr != nullptr, transposed
// [HD][TPT]; rows past S as zeros
template <int HD>
__device__ __forceinline__ void load_tc(bf16* nat, bf16* tr, const bf16* base,
                                        size_t row_stride, int r0, int S) {
    constexpr int CH = HD / 8;            // 16-byte chunks a row
    for (int e = threadIdx.x; e < TC_ROWS * CH; e += TC_THREADS_B) {
        const int r = e / CH, c = e % CH;
        const int s = r0 + r;
        uint4 x = make_uint4(0, 0, 0, 0);
        if (s < S)
            x = *reinterpret_cast<const uint4*>(base + (size_t)s * row_stride
                                                + c * 8);
        *reinterpret_cast<uint4*>(nat + r * (HD + 8) + c * 8) = x;
        if (tr != nullptr) {
            const bf16* xs = reinterpret_cast<const bf16*>(&x);
#pragma unroll
            for (int i = 0; i < 8; ++i) tr[(c * 8 + i) * TPT + r] = xs[i];
        }
    }
}

// dq: one block per (q tile of 64 rows, query head, batch); warp w owns
// rows 16 w .. 16 w + 15
template <int HD>
__global__ void __launch_bounds__(TC_THREADS_B)
swa_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths, bf16* __restrict__ dq,
                     int S, int KV, int G, int window, float scale) {
    constexpr int PN = HD + 8;
    constexpr int NT = HD / 8;            // n8 tiles of the head dim
    extern __shared__ __align__(16) unsigned char smem_tc[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_tc);      // [64][PN]
    bf16* dOs = Qs + TC_ROWS * PN;                     // [64][PN]
    bf16* Ks = dOs + TC_ROWS * PN;                     // [64][PN]
    bf16* Vs = Ks + TC_ROWS * PN;                      // [64][PN]
    bf16* KT = Vs + TC_ROWS * PN;                      // [HD][TPT]

    const int q0 = blockIdx.x * TC_ROWS;
    const int head = blockIdx.y;
    const int b = blockIdx.z;
    const int kv = head / G;
    const int H = KV * G;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q4 = lane & 3;
    const int n = lengths ? min(lengths[b], S) : S;
    const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
    const size_t qoff = (size_t)b * S * q_row + (size_t)head * HD;
    const size_t koff = (size_t)b * S * k_row + (size_t)kv * HD;
    const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

    if (q0 < n) {
        float row_lse[2], row_d[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int s = min(rows[r], S - 1);
            row_lse[r] = lse[((size_t)b * S + s) * H + head];
            row_d[r] = delta[((size_t)b * S + s) * H + head];
        }
        load_tc<HD>(Qs, nullptr, q + qoff, q_row, q0, S);
        load_tc<HD>(dOs, nullptr, dout + qoff, q_row, q0, S);
        const int q_last = min(q0 + TC_ROWS, n) - 1;
        const int kt_lo = max(0, q0 - window + 1) / TC_ROWS;
        const int kt_hi = q_last / TC_ROWS;
        for (int kt = kt_lo; kt <= kt_hi; ++kt) {
            const int k0 = kt * TC_ROWS;
            __syncthreads();
            load_tc<HD>(Ks, KT, k + koff, k_row, k0, S);
            load_tc<HD>(Vs, nullptr, v + koff, k_row, k0, S);
            __syncthreads();
            float sc[8][4], dp[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t aq[4], ad[4];
                frag_a(aq, Qs, PN, 16 * warp, 16 * kk, g, q4);
                frag_a(ad, dOs, PN, 16 * warp, 16 * kk, g, q4);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    uint32_t b0, b1;
                    frag_b(b0, b1, Ks, PN, 8 * j, 16 * kk, g, q4);
                    mma16816(sc[j], aq, b0, b1);
                    frag_b(b0, b1, Vs, PN, 8 * j, 16 * kk, g, q4);
                    mma16816(dp[j], ad, b0, b1);
                }
            }
            // sc <- ds = p (dp - D), p = exp(scale s - lse) in the band
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1;
                    const int qp = rows[r];
                    const int kp = k0 + 8 * j + 2 * q4 + (e & 1);
                    const bool ok = qp < n && kp < n && kp <= qp
                                    && qp - kp < window;
                    const float p = ok ? expf(sc[j][e] * scale - row_lse[r])
                                       : 0.0f;
                    sc[j][e] = p * (dp[j][e] - row_d[r]);
                }
            // acc += ds . k: A = ds (registers, hi + lo), B = k^T's rows;
            // the tile's sum on the tensor cores, added to acc in fp32
            uint32_t hi[4][4], lo[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) frag_split(sc, kk, hi[kk], lo[kk]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    uint32_t b0, b1;
                    frag_b(b0, b1, KT, TPT, 8 * j, 16 * kk, g, q4);
                    mma16816(t, hi[kk], b0, b1);
                    mma16816(t, lo[kk], b0, b1);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] += t[e];
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (rows[r] >= S) continue;
        bf16* out = dq + qoff + (size_t)rows[r] * q_row + 2 * q4;
#pragma unroll
        for (int j = 0; j < NT; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
                __floats2bfloat162_rn(acc[j][2 * r] * scale,
                                      acc[j][2 * r + 1] * scale);
    }
}

// dk and dv: one block per (key tile of 64 keys, KV head, batch), over the
// G query heads and the q tiles whose band reaches the tile; warp w owns
// keys 16 w .. 16 w + 15
template <int HD>
__global__ void __launch_bounds__(TC_THREADS_B)
swa_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ lengths, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int S, int KV, int G,
                       int window, float scale) {
    constexpr int PN = HD + 8;
    constexpr int NT = HD / 8;
    extern __shared__ __align__(16) unsigned char smem_tc[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_tc);      // [64][PN]
    bf16* Vs = Ks + TC_ROWS * PN;                      // [64][PN]
    bf16* Qs = Vs + TC_ROWS * PN;                      // [64][PN]
    bf16* dOs = Qs + TC_ROWS * PN;                     // [64][PN]
    bf16* QT = dOs + TC_ROWS * PN;                     // [HD][TPT]
    bf16* dOT = QT + HD * TPT;                         // [HD][TPT]
    float* cL = reinterpret_cast<float*>(dOT + HD * TPT);  // [64]
    float* cD = cL + TC_ROWS;                                // [64]

    const int k0 = blockIdx.x * TC_ROWS;
    const int kv = blockIdx.y;
    const int b = blockIdx.z;
    const int H = KV * G;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, q4 = lane & 3;
    const int n = lengths ? min(lengths[b], S) : S;
    const size_t q_row = (size_t)H * HD, k_row = (size_t)KV * HD;
    const size_t koff = (size_t)b * S * k_row + (size_t)kv * HD;
    const int keys[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};

    float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;

    if (k0 < n) {
        load_tc<HD>(Ks, nullptr, k + koff, k_row, k0, S);
        load_tc<HD>(Vs, nullptr, v + koff, k_row, k0, S);
        const int q_hi = min(k0 + TC_ROWS - 1 + window - 1, n - 1);
        const int qt_lo = k0 / TC_ROWS, qt_hi = q_hi / TC_ROWS;
        for (int gi = 0; gi < G; ++gi) {
            const int head = kv * G + gi;
            const size_t qoff = (size_t)b * S * q_row + (size_t)head * HD;
            for (int qt = qt_lo; qt <= qt_hi; ++qt) {
                const int q0 = qt * TC_ROWS;
                __syncthreads();
                load_tc<HD>(Qs, QT, q + qoff, q_row, q0, S);
                load_tc<HD>(dOs, dOT, dout + qoff, q_row, q0, S);
                for (int c = threadIdx.x; c < TC_ROWS; c += TC_THREADS_B) {
                    const int s = min(q0 + c, S - 1);
                    cL[c] = lse[((size_t)b * S + s) * H + head];
                    cD[c] = delta[((size_t)b * S + s) * H + head];
                }
                __syncthreads();
                // s^T = k q^T and dp^T = v dout^T: rows keys, columns q
                float sc[8][4], dp[8][4];
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk) {
                    uint32_t ak[4], av[4];
                    frag_a(ak, Ks, PN, 16 * warp, 16 * kk, g, q4);
                    frag_a(av, Vs, PN, 16 * warp, 16 * kk, g, q4);
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        uint32_t b0, b1;
                        frag_b(b0, b1, Qs, PN, 8 * j, 16 * kk, g, q4);
                        mma16816(sc[j], ak, b0, b1);
                        frag_b(b0, b1, dOs, PN, 8 * j, 16 * kk, g, q4);
                        mma16816(dp[j], av, b0, b1);
                    }
                }
                // sc <- p, dp <- ds
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int kp = keys[e >> 1];
                        const int c = 8 * j + 2 * q4 + (e & 1);
                        const int qp = q0 + c;
                        const bool ok = qp < n && kp < n && kp <= qp
                                        && qp - kp < window;
                        const float p = ok ? expf(sc[j][e] * scale - cL[c])
                                           : 0.0f;
                        sc[j][e] = p;
                        dp[j][e] = p * (dp[j][e] - cD[c]);
                    }
                // dv += p^T dout, dk += ds^T q: A in registers (hi + lo),
                // B the transposed tiles' rows; each tile's sums on the
                // tensor cores, added to the accumulators in fp32
                uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    frag_split(sc, kk, ph[kk], pl[kk]);
                    frag_split(dp, kk, sh[kk], sl[kk]);
                }
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    float tv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    float tk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        uint32_t b0, b1;
                        frag_b(b0, b1, dOT, TPT, 8 * j, 16 * kk, g, q4);
                        mma16816(tv, ph[kk], b0, b1);
                        mma16816(tv, pl[kk], b0, b1);
                        frag_b(b0, b1, QT, TPT, 8 * j, 16 * kk, g, q4);
                        mma16816(tk, sh[kk], b0, b1);
                        mma16816(tk, sl[kk], b0, b1);
                    }
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acc_v[j][e] += tv[e];
                        acc_k[j][e] += tk[e];
                    }
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (keys[r] >= S) continue;
        const size_t at = koff + (size_t)keys[r] * k_row + 2 * q4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
                __floats2bfloat162_rn(acc_k[j][2 * r] * scale,
                                      acc_k[j][2 * r + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
                __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
        }
    }
}

struct BwdArgs {
    const void *q, *k, *v, *o;
    const float* lse;
    const void* dout;
    const int* lengths;
    void *dq, *dk, *dv;
    float* delta;
    int B, S, KV, G, window;
    float scale;
    cudaStream_t stream;
};

template <typename T>
int launch_delta(const BwdArgs& a, int hd) {
    const int H = a.KV * a.G;
    const long long n_rows = (long long)a.B * a.S * H;
    const int rows_a_block = THREADS / 32;
    swa_bwd_delta_kernel<T><<<(unsigned)((n_rows + rows_a_block - 1)
                                         / rows_a_block),
                              THREADS, 0, a.stream>>>(
        (const T*)a.o, (const T*)a.dout, a.lengths, a.delta, a.S, H, hd,
        n_rows);
    return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_tc(const BwdArgs& a) {
    constexpr int PN = HD + 8;
    const int H = a.KV * a.G;
    if (a.B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    // rows are read in 16-byte chunks
    for (const void* p : {a.q, a.k, a.v, a.dout})
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
            return (int)cudaErrorInvalidValue;
    int err = launch_delta<bf16>(a, HD);
    if (err != 0) return err;
    const int n_tiles = (a.S + TC_ROWS - 1) / TC_ROWS;
    const int smem_dq = (4 * TC_ROWS * PN + HD * TPT) * 2;
    cudaError_t e = cudaFuncSetAttribute(
        swa_bwd_dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_dq);
    if (e != cudaSuccess) return (int)e;
    swa_bwd_dq_tc_kernel<HD><<<dim3(n_tiles, H, a.B), TC_THREADS_B, smem_dq,
                               a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, a.lse, a.delta, a.lengths, (bf16*)a.dq, a.S,
        a.KV, a.G, a.window, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int smem_kv = (4 * TC_ROWS * PN + 2 * HD * TPT) * 2
                        + 2 * TC_ROWS * (int)sizeof(float);
    e = cudaFuncSetAttribute(swa_bwd_dkdv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
    if (e != cudaSuccess) return (int)e;
    swa_bwd_dkdv_tc_kernel<HD><<<dim3(n_tiles, a.KV, a.B), TC_THREADS_B,
                                 smem_kv, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, a.lse, a.delta, a.lengths, (bf16*)a.dk,
        (bf16*)a.dv, a.S, a.KV, a.G, a.window, a.scale);
    return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_bwd(const BwdArgs& a) {
    constexpr int TR = BwdTile<HD>::TR, LDR = BwdTile<HD>::LDR;
    const int H = a.KV * a.G;
    if (a.B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    int status = launch_delta<T>(a, HD);
    if (status != 0) return status;
    cudaError_t err;
    const int n_tiles = (a.S + TR - 1) / TR;

    const int smem_dq = (2 * HD * LDR + 2 * HD * BLDC + BTC * LDR)
                        * (int)sizeof(float);
    err = cudaFuncSetAttribute(swa_bwd_dq_kernel<HD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_dq);
    if (err != cudaSuccess) return (int)err;
    swa_bwd_dq_kernel<HD, T><<<dim3(n_tiles, H, a.B), THREADS, smem_dq,
                               a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, a.lengths, (T*)a.dq, a.S, a.KV, a.G, a.window, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int smem_kv = (2 * HD * LDR + 2 * HD * BLDC + 2 * BTC * LDR
                         + 2 * BTC) * (int)sizeof(float);
    err = cudaFuncSetAttribute(swa_bwd_dkdv_kernel<HD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
    if (err != cudaSuccess) return (int)err;
    swa_bwd_dkdv_kernel<HD, T><<<dim3(n_tiles, a.KV, a.B), THREADS, smem_kv,
                                 a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, a.lengths, (T*)a.dk, (T*)a.dv, a.S, a.KV, a.G, a.window,
        a.scale);
    return (int)cudaGetLastError();
}

// bf16: the tensor-core body up to head dim 128, the SIMT body at 256;
// fp32: the SIMT body
template <typename T>
int bwd_dispatch(int hd, const BwdArgs& a) {
    if constexpr (std::is_same<T, bf16>::value) {
        switch (hd) {
            case 16: return launch_bwd_tc<16>(a);
            case 32: return launch_bwd_tc<32>(a);
            case 64: return launch_bwd_tc<64>(a);
            case 128: return launch_bwd_tc<128>(a);
            case 256: return launch_bwd<256, T>(a);
            default: return (int)cudaErrorInvalidValue;
        }
    } else {
        switch (hd) {
            case 16: return launch_bwd<16, T>(a);
            case 32: return launch_bwd<32, T>(a);
            case 64: return launch_bwd<64, T>(a);
            case 128: return launch_bwd<128, T>(a);
            case 256: return launch_bwd<256, T>(a);
            default: return (int)cudaErrorInvalidValue;
        }
    }
}

}  // namespace

// The backward: dq, dk, dv (the inputs' layouts and dtype) from q, k, v,
// the forward's output o and lse, and dout; delta is (B, S, KV, G) fp32
// scratch.  Three launches on `stream`.
extern "C" int swa_attn_bwd_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   const int* lengths, void* dq, void* dk,
                                   void* dv, float* delta, int B, int S,
                                   int KV, int G, int hd, int window,
                                   float scale, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || window <= 0)
        return (int)cudaErrorInvalidValue;
    const BwdArgs a{q, k, v, o, lse, dout, lengths, dq, dk, dv, delta, B, S,
                    KV, G, window, scale, (cudaStream_t)stream};
    if (dtype == 0) return bwd_dispatch<float>(hd, a);
    if (dtype == 1) return bwd_dispatch<bf16>(hd, a);
    return (int)cudaErrorInvalidValue;
}
