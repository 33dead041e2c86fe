// Causal sliding-window attention, backward, for Hopper (sm_90a): dq, dk
// and dv of the forward in swa_attn.cu, from its output and the lse it
// writes when autograd needs it.  bf16 or fp32 in and out.
//
// No TPU kernel matches it: the reference trains through jax.grad of its
// XLA band gather (src/repro/models/attention.py:_mha_band).  Layout, the
// band and the lengths are the forward's (its source has the details):
// q, dq and dout (B, S, KV, G, hd), k, v, dk and dv (B, S, KV, hd), out
// like q, lse (B, S, KV, G) fp32.  The gradient of the forward (p kept
// fp32 for p . v), from its output o and each row's lse = m + log l
// (natural units):
//
//   p_sj = exp(scale q_s . k_j - lse_s)        (0 outside the band)
//   dp_sj = dout_s . v_j,   D_s = dout_s . o_s,   ds_sj = p_sj (dp_sj - D_s)
//   dq_s = scale sum_j ds_sj k_j,   dk_j = scale sum_s ds_sj q_s,
//   dv_j = sum_s p_sj dout_s
//
// where s runs over the G query heads of k_j's KV head as well.  Rows at or
// past a row's length have p = 0 (their output is the zero the forward
// wrote), so they give nothing, and keys at or past it get zero dk / dv.
// Every output element is summed in a fixed order and nothing is summed by
// atomics, so two launches on the same inputs agree bit for bit.
//
// What bounds it: operations, 10 hd FLOP a (query, key) pair and query
// head (s, dp, dq, dk, dv).  At starcoder2-3b's training shape (B 2, S
// 8,192, 24 heads of 128, window 4,096) that is 1,546 GFLOP, 1.56 ms at
// the bf16 tensor-core peak (989 TFLOP/s) and 23.1 ms at the fp32 peak.
//
// bf16 (the training path): wgmma, operands by TMA, four launches.
//   1. rows: D_s, and lse_s in log2 units, into fp32 scratch laid out (2,
//      B, heads, S rounded up to 64), so that a tile's 64 rows are one
//      TMA box.
//   2. dq: one block per (q tile, query head, batch), the q tiles longest
//      band first, as the forward; q and dout resident, the K and V tiles
//      of 64 keys the tile's band reaches streamed.  s = q k^T and dp =
//      dout v^T are SS products (both operands K-major in shared memory);
//      ds = p (dp - D) is formed in fp32 registers, split into bf16 hi +
//      lo, and dq += ds k runs with ds as the register A operand against
//      the same K tile read MN-major.
//   3. dk / dv: one block per (key tile, query head, batch), the key tiles
//      longest band first; K and V resident, the (q, dout, lse, D) tiles
//      of 64 rows the keys' band reaches streamed.  s^T = k q^T and dp^T =
//      v dout^T are SS products; p and ds in fp32 registers, split hi +
//      lo, are the register A operands of dv += p^T dout and dk += ds^T q
//      against the q and dout tiles read MN-major.  A block sums one query
//      head only, into fp32 scratch (G, B, S, KV, hd) for dk and for dv.
//   4. reduce: dk = scale sum_g, dv = sum_g over that scratch, g in order,
//      rounded to bf16.
// Each of the product kernels has two consumer warpgroups and a producer
// warpgroup, one thread of which keeps the TMA loads in flight: the
// resident tiles on one mbarrier, the streamed ones in a ring of stages
// with a "full" (TMA bytes) and an "empty" (every consumer warp) mbarrier a
// stage, as the forward's bf16 body.  setmaxnreg gives the producer 24
// registers a thread and the consumers 240 (a launch holds 168 a thread:
// 384 x 168 = 128 x 24 + 256 x 240), and the launcher refuses a build that
// holds fewer, whose consumers would wait for registers forever.  A
// warpgroup skips a tile that holds no valid pair for its rows and masks
// per element only a tile that crosses the band's edges, the ragged S or a
// row's length.  Tiles are 128-byte-swizzled boxes of 64 columns (head dims
// below 64 padded with zeros, rows past S read as zeros).
//
// The head dim of the outputs is split across the two warpgroups where
// their accumulators would not fit: a warpgroup's dk and dv for 64 keys x
// 128 columns take 128 fp32 registers a thread, and with s, dp and their
// fragments the consumers need more than their 240.  So in dk / dv from
// head dim 128, and in dq at 256, the two warpgroups of a block share its
// 64 rows, each computing the whole s and dp (the SS products over all the
// columns) and the outputs' half of the columns; below that each owns 64 of
// the block's 128 rows.  At starcoder2-3b's shape the backward ran 9.00
// ms with nothing spilled at head dim 128, against 13.34 ms with 128
// columns a dk / dv warpgroup (724 bytes of spill stores), although s and
// dp run twice; dq split as well ran 9.99 ms, for it has room for its
// accumulator unsplit.  ptxas allocates the consumers' code within what
// setmaxnreg gives them (at 224 a thread dk / dv spills 16 bytes at head
// dim 128, at 240 none).  At 256 dk / dv still spills 612 bytes.
// Exchanging half-sums of s and dp through shared memory instead of
// recomputing them would need 64 KB more than the 193 KB that the resident
// tiles and two stages take at 256, and a barrier between the warpgroups
// every tile.
//
// Numerics.  q, k, v and dout are bf16, so s and dp are exact products
// summed in fp32.  p and ds are fp32: as the forward's p . v, each is split
// into bf16 hi = bf16(x) and lo = bf16(x - hi) and multiplied twice, leaving
// ~2^-17 relative error in each term (a bf16 p alone put small outputs, where
// terms cancel, past the one-bf16-ulp bar).  So the tensor cores run 8 hd
// FLOP a (query, key) pair and head in dq (s, dp, ds k twice; 12 at head
// dim 256, where s and dp run in both warpgroups) and 12 in dk / dv (s^T,
// dp^T, p^T dout and ds^T q twice; 16 from head dim 128), against the
// bound's 10 for the whole.  Tensor-core chains stay short: one chain over
// the band and all G heads (up to 4,096 x 12 rows) put dk at 1.27x its bar
// on an H100, so each accumulator here chains over one query head's band
// only (up to window + 63 rows or keys) and dk / dv sum the G heads in fp32
// in step 4; chip_smoke.py holds every edge and training shape to the bar
// (0.990 of it at most on an H100, as with dq summing each 64-key tile from
// zero).  Splitting the heads across blocks also fills the card: B KV G S /
// 64 blocks for dk / dv at head dim 128 (6,144 at starcoder2-3b's shape).
// (scripts/swa_bwd_variants.py builds variants of this source, holds and
// times them side by side; the times and spills above are its run on an
// H100 80GB HBM3 at 700 W.)
//
// fp32 (the agreement phase and the tests): an fp32 SIMT body of three
// launches, D (one warp a row), dq (one block per q tile and query head,
// over the key tiles the tile's band reaches) and dk / dv (one block per key
// tile and KV head, over the G heads and the q tiles whose band reaches the
// tile).  A block of 256 threads (16 x 16) holds a resident tile of TR rows
// (q and dout for dq; k and v for dk / dv) and streams tiles of TC = 64
// columns (k and v; q and dout), every tile transposed in shared memory;
// thread (ty, tx) computes the scores and dp of rows RI ty .. RI ty + RI -
// 1 and columns 4 tx .. 4 tx + 3 with fp32 FMAs, then accumulates its rows'
// output columns tx + 16 c.  TR is 64, but 32 at head dim 256, where four
// 64-row tiles of fp32 would not fit in shared memory.
#include <cmath>

#include "hopper.cuh"

#define THREADS 256

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---- fp32: SIMT ---------------------------------------------------------

constexpr int BTC = 64;                   // streamed columns a tile
constexpr int BLDC = BTC + 4;

template <int HD>
struct BwdTile {
    static constexpr int TR = HD > 128 ? 32 : 64;
    static constexpr int RI = TR / 16;
    static constexpr int LDR = TR + 4;
    static constexpr int DPT = HD / 16;
};

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
// shared [HD][ld], transposed; rows past S as zeros
template <int HD>
__device__ __forceinline__ void load_t(float* dst, int ld, const float* base,
                                       size_t row_stride, int r0, int rows,
                                       int S) {
    for (int e = threadIdx.x; e < rows * HD; e += THREADS) {
        const int r = e / HD, d = e % HD;
        const int s = r0 + r;
        dst[d * ld + r] = s < S ? base[(size_t)s * row_stride + d] : 0.0f;
    }
}

__global__ void __launch_bounds__(THREADS)
swa_bwd_delta_kernel(const float* __restrict__ o,
                     const float* __restrict__ dout,
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
            acc = fmaf(o[row * hd + d], dout[row * hd + d], acc);
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
template <int HD>
__global__ void __launch_bounds__(THREADS)
swa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ lengths, float* __restrict__ dq,
                  int S, int KV, int G, int window, float scale) {
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
            dq[qoff + (size_t)s * q_row + tx + 16 * col] = acc[i][col] * scale;
    }
}

// dk and dv: one block per (key tile of TR keys, KV head, batch), over the G
// query heads of the KV head and the q tiles whose band reaches the tile
template <int HD>
__global__ void __launch_bounds__(THREADS)
swa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lengths, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int KV, int G, int window,
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
            dk[at] = acc_k[i][col] * scale;
            dv[at] = acc_v[i][col];
        }
    }
}

// ---- bf16: wgmma, operands by TMA from a producer warpgroup -------------

// the tensor-core body's tiles at head dim HD (the note at the top)
template <int HD, bool SPLIT>
struct BwdTc {
    static constexpr int HDP = HD < 64 ? 64 : HD;   // columns in shared
    static constexpr int NA = HDP / 64;             // 128-byte atoms a row
    static constexpr int NWG = 2;                   // consumer warpgroups
    static constexpr int NSPLIT = SPLIT ? 2 : 1;    // warpgroups a row set
    static constexpr int ROWS = 64 * NWG / NSPLIT;  // resident rows a block
    static constexpr int NCOL = HDP / NSPLIT;       // output columns a wg
    static constexpr int NACC = NCOL / 2;           // their registers a thread
    static constexpr int STAGES = HD > 128 ? 2 : 4;
    static constexpr int NTHREADS = 128 * (NWG + 1);    // + the producer's
    static constexpr uint32_t TILE = BN * HDP * 2;  // bytes, a streamed tile
    static constexpr uint32_t RES = ROWS * HDP * 2; // bytes, a resident tile
    // registers a thread: the launch's share, the producer's, the consumers'
    static constexpr int REGS = 65536 / NTHREADS / 8 * 8;
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int CONSUMER_REGS = 240;
    static constexpr int NEED = 128 * PRODUCER_REGS
                                + 128 * NWG * CONSUMER_REGS;
    static_assert(NEED <= NTHREADS * REGS, "setmaxnreg asks for more "
                  "registers than the block holds");
};

// dq splits the head dim only at 256, dk / dv from 128 (the note above)
template <int HD> using DqTile = BwdTc<HD, (HD > 128)>;
template <int HD> using DkdvTile = BwdTc<HD, (HD > 64)>;

__device__ __forceinline__ void producer_regs() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// d (m64 n64) = a . b^T over the head dim: a the warpgroup's 64 rows, from
// row r0, of a resident tile of `rows` rows; b a streamed tile of BN rows;
// both K-major
template <int HD>
__device__ __forceinline__ void ss_scores(float (&d)[32], uint32_t a,
                                          int rows, int r0, uint32_t b) {
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
        wgmma_ss_n64(d,
                     smem_desc(a + (c / 4) * rows * 128 + r0 * 128
                               + (c % 4) * 32, 16, 1024),
                     smem_desc(b + (c / 4) * BN * 128 + (c % 4) * 32, 16,
                               1024), c > 0);
}

// the k16 A fragments (hi, lo) of an m64 n64 fp32 accumulator: x[4 j + e]
// is row g + 8 (e / 2), column 8 j + 2 tq + e % 2 of the warp's 16 rows
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
            split_p(x[8 * kk + 2 * f], x[8 * kk + 2 * f + 1], hi[kk][f],
                    lo[kk][f]);
}

// d (m64 x NCOL) += x . t: x (m64 k64, bf16 hi then lo) in registers, t a
// streamed tile whose BN rows are the reduction, its columns col0 ..
// col0 + NCOL - 1 read MN-major
template <int NCOL, int NACC>
__device__ __forceinline__ void rs_tile(float (&d)[NACC],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4], uint32_t t,
                                        int col0) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t b = smem_desc(t + (col0 / 64) * BN * 128
                                         + kk * 16 * 128, BN * 128, 1024);
            if constexpr (NCOL == 128)
                wgmma_rs_n128<0>(d, half ? lo[kk] : hi[kk], b);
            else
                wgmma_rs_n64(d, half ? lo[kk] : hi[kk], b);
        }
}

// step 1: rinfo (2, B, H, SP) <- lse in log2 units, D; rows past S zeros
__global__ void __launch_bounds__(THREADS)
swa_bwd_rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const int* __restrict__ lengths, float* __restrict__ rinfo,
                    int S, int SP, int H, int hd, long long n_rows) {
    const long long row = (long long)blockIdx.x * (THREADS / 32)
                          + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= n_rows) return;
    const int s = (int)(row % SP);
    const int head = (int)((row / SP) % H);
    const int b = (int)(row / ((long long)SP * H));
    const int n = lengths ? min(lengths[b], S) : S;
    float acc = 0.0f, l2 = 0.0f;
    if (s < S) {
        const size_t src = ((size_t)b * S + s) * H + head;
        if (s < n)
            for (int d = lane; d < hd; d += 32)
                acc = fmaf(__bfloat162float(o[src * hd + d]),
                           __bfloat162float(dout[src * hd + d]), acc);
        l2 = lse[src] * LOG2E;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
        rinfo[row] = l2;
        rinfo[n_rows + row] = acc;
    }
}

// step 2, dq: one block per (q tile of ROWS rows, query head, batch)
template <int HD>
__global__ void __launch_bounds__(DqTile<HD>::NTHREADS, 1)
swa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const float* __restrict__ rinfo,
                     const int* __restrict__ lengths, bf16* __restrict__ dq,
                     int S, int SP, int KV, int G, int window,
                     float scale_log2, float scale) {
    using C = DqTile<HD>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t dos = qs + C::RES;               // dout, resident
    const uint32_t ks = dos + C::RES;               // [STAGES] K tiles
    const uint32_t vs = ks + C::STAGES * C::TILE;   // [STAGES] V tiles
    const uint32_t full = vs + C::STAGES * C::TILE; // [STAGES] mbarriers
    const uint32_t empty = full + 8 * C::STAGES;    // [STAGES]
    const uint32_t res = empty + 8 * C::STAGES;     // the resident tiles

    const int head = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * C::ROWS;  // longest first
    const int kv = head / G;
    const int H = KV * G;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int n = lengths ? min(lengths[b], S) : S;
    int kt_lo = 0, n_tiles = 0;
    if (q0 < n) {
        kt_lo = max(0, q0 - window + 1) / BN;
        n_tiles = (min(q0 + C::ROWS, n) - 1) / BN - kt_lo + 1;
    }

    if (tid == 0) {
        for (int st = 0; st < C::STAGES; ++st) {
            mbar_init(full + 8 * st, 1);            // the producer's expect_tx
            mbar_init(empty + 8 * st, 4 * C::NWG);  // every consumer warp
        }
        mbar_init(res, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 128 * C::NWG) {                      // the producer
        producer_regs();
        if (tid == 128 * C::NWG && n_tiles > 0) {
            mbar_expect_tx(res, 2 * C::RES);
#pragma unroll
            for (int a = 0; a < C::NA; ++a)
#pragma unroll
                for (int r = 0; r < C::ROWS / BN; ++r) {
                    const uint32_t at = a * C::ROWS * 128 + r * BN * 128;
                    tma_load_4d(qs + at, &qmap, res, a * 64, head,
                                q0 + r * BN, b);
                    tma_load_4d(dos + at, &dmap, res, a * 64, head,
                                q0 + r * BN, b);
                }
            for (int i = 0; i < n_tiles; ++i) {
                const int st = i % C::STAGES;
                if (i >= C::STAGES)                 // read in the last round
                    mbar_wait(empty + 8 * st, (i / C::STAGES - 1) & 1);
                mbar_expect_tx(full + 8 * st, 2 * C::TILE);
                const int k0 = (kt_lo + i) * BN;
#pragma unroll
                for (int a = 0; a < C::NA; ++a) {
                    tma_load_4d(ks + st * C::TILE + a * BN * 128, &kmap,
                                full + 8 * st, a * 64, kv, k0, b);
                    tma_load_4d(vs + st * C::TILE + a * BN * 128, &vmap,
                                full + 8 * st, a * 64, kv, k0, b);
                }
            }
        }
    } else {                                        // the consumers
        consumer_regs();
        const int wg = tid / 128;
        const int gq = lane >> 2, tq = lane & 3;
        const int qr = C::NSPLIT == 1 ? wg * 64 : 0;    // its rows in the tile
        const int col0 = C::NSPLIT == 1 ? 0 : wg * C::NCOL;
        const int wq = q0 + qr;                     // its first q row
        const int rows[2] = {wq + (warp % 4) * 16 + gq,
                             wq + (warp % 4) * 16 + gq + 8};
        const size_t rrow = ((size_t)b * H + head) * SP;
        const size_t plane = (size_t)gridDim.y * H * SP;
        float row_l[2], row_d[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const size_t at = rrow + min(rows[r], SP - 1);
            row_l[r] = rinfo[at];
            row_d[r] = rinfo[plane + at];
        }
        float acc[C::NACC];
#pragma unroll
        for (int d = 0; d < C::NACC; ++d) acc[d] = 0.0f;
        if (n_tiles > 0) mbar_wait(res, 0);

        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % C::STAGES;
            mbar_wait(full + 8 * st, (i / C::STAGES) & 1);
            const int k0 = (kt_lo + i) * BN;
            // a tile with no valid pair for the warpgroup's 64 rows
            if (k0 > wq + 63 || k0 >= n || wq >= n
                || wq - (k0 + BN - 1) >= window) {
                if (lane == 0) mbar_arrive(empty + 8 * st);
                continue;
            }
            const bool interior = k0 + BN - 1 <= wq && wq + 63 - k0 < window
                                  && k0 + BN <= n && wq + 64 <= n;
            const uint32_t kt = ks + st * C::TILE;
            const uint32_t vt = vs + st * C::TILE;

            // s = q k^T, dp = dout v^T
            float sc[32], dp[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
            wgmma_fence();
            fence_regs(sc);
            fence_regs(dp);
            ss_scores<HD>(sc, qs, C::ROWS, qr, kt);
            ss_scores<HD>(dp, dos, C::ROWS, qr, vt);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            fence_regs(dp);

            // sc <- ds = p (dp - D); sc[4 j + e] is row rows[e / 2], key
            // k0 + 8 j + 2 tq + e % 2
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1;
                    float p = exp2f(sc[4 * j + e] * scale_log2 - row_l[r]);
                    if (!interior) {
                        const int qp = rows[r];
                        const int kp = k0 + 8 * j + 2 * tq + (e & 1);
                        if (!(qp < n && kp < n && kp <= qp
                              && qp - kp < window))
                            p = 0.0f;
                    }
                    sc[4 * j + e] = p * (dp[4 * j + e] - row_d[r]);
                }

            // dq += ds k, in the accumulator's chain
            uint32_t hi[4][4], lo[4][4];
            split_frags(sc, hi, lo);
            wgmma_fence();
            fence_regs(acc);
            fence_regs(hi);
            fence_regs(lo);
            rs_tile<C::NCOL>(acc, hi, lo, kt, col0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(hi);
            fence_regs(lo);
            if (lane == 0) mbar_arrive(empty + 8 * st);     // stage read
        }

        const size_t q_row = (size_t)H * HD;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int s = rows[r];
            if (s >= S) continue;
            bf16* out = dq + ((size_t)b * S + s) * q_row + (size_t)head * HD;
#pragma unroll
            for (int j = 0; j < C::NCOL / 8; ++j) {
                const int c = col0 + 8 * j + 2 * tq;
                if (c < HD)
                    *reinterpret_cast<__nv_bfloat162*>(out + c) =
                        __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                              acc[4 * j + 2 * r + 1] * scale);
            }
        }
    }
}

// step 3, dk and dv of one query head: one block per (key tile of ROWS
// keys, query head, batch), into part_k / part_v (G, B, S, KV, HD), dk
// unscaled
template <int HD>
__global__ void __launch_bounds__(DkdvTile<HD>::NTHREADS, 1)
swa_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap rmap,
                       const int* __restrict__ lengths,
                       float* __restrict__ part_k, float* __restrict__ part_v,
                       int S, int KV, int G, int window, float scale_log2) {
    using C = DkdvTile<HD>;
    constexpr uint32_t RB = 2 * BN * 4;             // lse and D of a tile
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = smem_u32(smem_raw);
    const uint32_t ks = (base + 1023) & ~1023u;     // K, resident
    const uint32_t vs = ks + C::RES;                // V, resident
    const uint32_t qt = vs + C::RES;                // [STAGES] q tiles
    const uint32_t dt = qt + C::STAGES * C::TILE;   // [STAGES] dout tiles
    const uint32_t rt = dt + C::STAGES * C::TILE;   // [STAGES] lse, D
    const uint32_t full = rt + C::STAGES * RB;      // [STAGES] mbarriers
    const uint32_t empty = full + 8 * C::STAGES;    // [STAGES]
    const uint32_t res = empty + 8 * C::STAGES;     // the resident tiles
    const float* rows_s = reinterpret_cast<const float*>(smem_raw
                                                         + (rt - base));

    const int head = blockIdx.x;
    const int b = blockIdx.y;
    const int k0 = blockIdx.z * C::ROWS;    // the first keys' bands are the
                                            // longest: they go first
    const int kv = head / G, g = head % G;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int n = lengths ? min(lengths[b], S) : S;
    int qt_lo = 0, n_tiles = 0;
    if (k0 < n) {
        qt_lo = k0 / BN;
        n_tiles = min(k0 + C::ROWS - 1 + window - 1, n - 1) / BN - qt_lo + 1;
    }

    if (tid == 0) {
        for (int st = 0; st < C::STAGES; ++st) {
            mbar_init(full + 8 * st, 1);
            mbar_init(empty + 8 * st, 4 * C::NWG);
        }
        mbar_init(res, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 128 * C::NWG) {                      // the producer
        producer_regs();
        if (tid == 128 * C::NWG && n_tiles > 0) {
            mbar_expect_tx(res, 2 * C::RES);
#pragma unroll
            for (int a = 0; a < C::NA; ++a)
#pragma unroll
                for (int r = 0; r < C::ROWS / BN; ++r) {
                    const uint32_t at = a * C::ROWS * 128 + r * BN * 128;
                    tma_load_4d(ks + at, &kmap, res, a * 64, kv, k0 + r * BN,
                                b);
                    tma_load_4d(vs + at, &vmap, res, a * 64, kv, k0 + r * BN,
                                b);
                }
            for (int i = 0; i < n_tiles; ++i) {
                const int st = i % C::STAGES;
                if (i >= C::STAGES)
                    mbar_wait(empty + 8 * st, (i / C::STAGES - 1) & 1);
                mbar_expect_tx(full + 8 * st, 2 * C::TILE + RB);
                const int q0 = (qt_lo + i) * BN;
#pragma unroll
                for (int a = 0; a < C::NA; ++a) {
                    tma_load_4d(qt + st * C::TILE + a * BN * 128, &qmap,
                                full + 8 * st, a * 64, head, q0, b);
                    tma_load_4d(dt + st * C::TILE + a * BN * 128, &dmap,
                                full + 8 * st, a * 64, head, q0, b);
                }
                tma_load_4d(rt + st * RB, &rmap, full + 8 * st, q0, head, b,
                            0);
                tma_load_4d(rt + st * RB + BN * 4, &rmap, full + 8 * st, q0,
                            head, b, 1);
            }
        }
    } else {                                        // the consumers
        consumer_regs();
        const int wg = tid / 128;
        const int gq = lane >> 2, tq = lane & 3;
        const int kr = C::NSPLIT == 1 ? wg * 64 : 0;    // its keys in the tile
        const int col0 = C::NSPLIT == 1 ? 0 : wg * C::NCOL;
        const int kw = k0 + kr;                     // its first key
        const int keys[2] = {kw + (warp % 4) * 16 + gq,
                             kw + (warp % 4) * 16 + gq + 8};
        float dk[C::NACC], dv[C::NACC];
#pragma unroll
        for (int d = 0; d < C::NACC; ++d) dk[d] = dv[d] = 0.0f;
        if (n_tiles > 0) mbar_wait(res, 0);

        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % C::STAGES;
            mbar_wait(full + 8 * st, (i / C::STAGES) & 1);
            const int q0 = (qt_lo + i) * BN;
            // a tile with no valid pair for the warpgroup's 64 keys
            if (q0 + BN - 1 < kw || kw >= n || q0 - (kw + 63) >= window) {
                if (lane == 0) mbar_arrive(empty + 8 * st);
                continue;
            }
            const bool interior = q0 >= kw + 63 && q0 + BN - 1 - kw < window
                                  && q0 + BN <= n && kw + 64 <= n;
            const uint32_t qtile = qt + st * C::TILE;
            const uint32_t dtile = dt + st * C::TILE;

            // s^T = k q^T, dp^T = v dout^T: rows keys, columns queries
            float sc[32], dp[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
            wgmma_fence();
            fence_regs(sc);
            fence_regs(dp);
            ss_scores<HD>(sc, ks, C::ROWS, kr, qtile);
            ss_scores<HD>(dp, vs, C::ROWS, kr, dtile);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            fence_regs(dp);

            // sc <- p, dp <- ds; sc[4 j + e] is key keys[e / 2], query q0 +
            // 8 j + 2 tq + e % 2, whose lse and D the stage holds
            const float* lrow = rows_s + st * 2 * BN;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float2 l2 = *reinterpret_cast<const float2*>(
                    lrow + 8 * j + 2 * tq);
                const float2 d2 = *reinterpret_cast<const float2*>(
                    lrow + BN + 8 * j + 2 * tq);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = exp2f(sc[4 * j + e] * scale_log2
                                    - ((e & 1) ? l2.y : l2.x));
                    if (!interior) {
                        const int qp = q0 + 8 * j + 2 * tq + (e & 1);
                        const int kp = keys[e >> 1];
                        if (!(qp < n && kp < n && kp <= qp
                              && qp - kp < window))
                            p = 0.0f;
                    }
                    sc[4 * j + e] = p;
                    dp[4 * j + e] = p * (dp[4 * j + e]
                                         - ((e & 1) ? d2.y : d2.x));
                }
            }

            // dv += p^T dout, then dk += ds^T q, in the accumulators'
            // chain; ds is split while dv's products run
            uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
            split_frags(sc, ph, pl);
            wgmma_fence();
            fence_regs(dv);
            fence_regs(ph);
            fence_regs(pl);
            rs_tile<C::NCOL>(dv, ph, pl, dtile, col0);
            wgmma_commit();
            split_frags(dp, sh, sl);
            wgmma_fence();
            fence_regs(dk);
            fence_regs(sh);
            fence_regs(sl);
            rs_tile<C::NCOL>(dk, sh, sl, qtile, col0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dk);
            fence_regs(dv);
            fence_regs(ph);
            fence_regs(pl);
            fence_regs(sh);
            fence_regs(sl);
            if (lane == 0) mbar_arrive(empty + 8 * st);     // stage read
        }

        const size_t k_row = (size_t)KV * HD;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int s = keys[r];
            if (s >= S) continue;
            const size_t at = (((size_t)g * gridDim.y + b) * S + s) * k_row
                              + (size_t)kv * HD;
#pragma unroll
            for (int j = 0; j < C::NCOL / 8; ++j) {
                const int c = col0 + 8 * j + 2 * tq;
                if (c < HD) {
                    *reinterpret_cast<float2*>(part_k + at + c) =
                        make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
                    *reinterpret_cast<float2*>(part_v + at + c) =
                        make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
                }
            }
        }
    }
}

// step 4: dk = scale sum_g part_k[g], dv = sum_g part_v[g], g in order
__global__ void __launch_bounds__(THREADS)
swa_bwd_reduce_kernel(const float4* __restrict__ part_k,
                      const float4* __restrict__ part_v,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      long long n4, int G, float scale) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n4) return;
    float4 sk = part_k[i], sv = part_v[i];
    for (int g = 1; g < G; ++g) {
        const float4 a = part_k[g * n4 + i], c = part_v[g * n4 + i];
        sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
        sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * i;
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * i;
    ok[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
    ok[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// rinfo (2, B, H, SP) fp32 as a 4-d map (SP, H, B, 2) in boxes of BN rows
bool rows_map(CUtensorMap* map, float* ptr, int B, int H, int SP) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return false;
    const cuuint64_t dims[4] = {(cuuint64_t)SP, (cuuint64_t)H, (cuuint64_t)B,
                                2};
    const cuuint64_t strides[3] = {(cuuint64_t)SP * 4,
                                   (cuuint64_t)H * SP * 4,
                                   (cuuint64_t)B * H * SP * 4};
    const cuuint32_t box[4] = {BN, 1, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, dims, strides,
                  box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct BwdArgs {
    const void *q, *k, *v, *o;
    const float* lse;
    const void* dout;
    const int* lengths;
    void *dq, *dk, *dv;
    float* scratch;
    int B, S, KV, G, window;
    float scale;
    cudaStream_t stream;
};

int round_rows(int S) { return (S + BN - 1) / BN * BN; }

// setmaxnreg only moves registers the block holds: refuse a build whose
// kernel holds fewer than the consumers ask for (its launch would hang)
template <typename K>
cudaError_t check_regs(K kernel, int nthreads, int need) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    return attr.numRegs * nthreads >= need ? cudaSuccess
                                           : cudaErrorInvalidConfiguration;
}

template <int HD>
int launch_bwd_tc(const BwdArgs& a) {
    using Q = DqTile<HD>;
    using K = DkdvTile<HD>;
    const int H = a.KV * a.G;
    const int SP = round_rows(a.S);
    const int n_qb = (a.S + Q::ROWS - 1) / Q::ROWS;
    const int n_kb = (a.S + K::ROWS - 1) / K::ROWS;
    if (a.B > 65535 || n_qb > 65535 || n_kb > 65535)
        return (int)cudaErrorInvalidValue;
    const long long n_rows = (long long)a.B * H * SP;
    const long long plane = (long long)a.B * a.S * a.KV * HD;
    float* rinfo = a.scratch;
    float* part_k = rinfo + 2 * n_rows;
    float* part_v = part_k + a.G * plane;
    CUtensorMap qm, dm, km, vm, rm;
    if (!bshd_map(&qm, a.q, a.B, a.S, H, HD)
        || !bshd_map(&dm, a.dout, a.B, a.S, H, HD)
        || !bshd_map(&km, a.k, a.B, a.S, a.KV, HD)
        || !bshd_map(&vm, a.v, a.B, a.S, a.KV, HD)
        || !rows_map(&rm, rinfo, a.B, H, SP))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = check_regs(swa_bwd_dq_tc_kernel<HD>, Q::NTHREADS,
                               Q::NEED);
    if (e == cudaSuccess)
        e = check_regs(swa_bwd_dkdv_tc_kernel<HD>, K::NTHREADS, K::NEED);
    if (e != cudaSuccess) return (int)e;

    const int rows_a_block = THREADS / 32;
    swa_bwd_rows_kernel<<<(unsigned)((n_rows + rows_a_block - 1)
                                     / rows_a_block), THREADS, 0,
                          a.stream>>>(
        (const bf16*)a.o, (const bf16*)a.dout, a.lse, a.lengths, rinfo, a.S,
        SP, H, HD, n_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const int smem_dq = 1024 + 2 * Q::RES + 2 * Q::STAGES * Q::TILE
                        + 8 * (2 * Q::STAGES + 1);
    e = cudaFuncSetAttribute(swa_bwd_dq_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
    if (e != cudaSuccess) return (int)e;
    swa_bwd_dq_tc_kernel<HD><<<dim3(H, a.B, n_qb), Q::NTHREADS, smem_dq,
                               a.stream>>>(
        qm, dm, km, vm, rinfo, a.lengths, (bf16*)a.dq, a.S, SP, a.KV, a.G,
        a.window, a.scale * LOG2E, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const int smem_kv = 1024 + 2 * K::RES + 2 * K::STAGES * K::TILE
                        + K::STAGES * 2 * BN * 4 + 8 * (2 * K::STAGES + 1);
    e = cudaFuncSetAttribute(swa_bwd_dkdv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
    if (e != cudaSuccess) return (int)e;
    swa_bwd_dkdv_tc_kernel<HD><<<dim3(H, a.B, n_kb), K::NTHREADS, smem_kv,
                                 a.stream>>>(
        qm, dm, km, vm, rm, a.lengths, part_k, part_v, a.S, a.KV, a.G,
        a.window, a.scale * LOG2E);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const long long n4 = plane / 4;
    swa_bwd_reduce_kernel<<<(unsigned)((n4 + THREADS - 1) / THREADS),
                            THREADS, 0, a.stream>>>(
        (const float4*)part_k, (const float4*)part_v, (bf16*)a.dk,
        (bf16*)a.dv, n4, a.G, a.scale);
    return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_simt(const BwdArgs& a) {
    constexpr int TR = BwdTile<HD>::TR, LDR = BwdTile<HD>::LDR;
    const int H = a.KV * a.G;
    if (a.B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const long long n_rows = (long long)a.B * a.S * H;
    const int rows_a_block = THREADS / 32;
    swa_bwd_delta_kernel<<<(unsigned)((n_rows + rows_a_block - 1)
                                      / rows_a_block), THREADS, 0,
                           a.stream>>>(
        (const float*)a.o, (const float*)a.dout, a.lengths, a.scratch, a.S, H,
        HD, n_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (a.S + TR - 1) / TR;

    const int smem_dq = (2 * HD * LDR + 2 * HD * BLDC + BTC * LDR)
                        * (int)sizeof(float);
    err = cudaFuncSetAttribute(swa_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_dq);
    if (err != cudaSuccess) return (int)err;
    swa_bwd_dq_kernel<HD><<<dim3(n_tiles, H, a.B), THREADS, smem_dq,
                            a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.scratch, a.lengths, (float*)a.dq, a.S,
        a.KV, a.G, a.window, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int smem_kv = (2 * HD * LDR + 2 * HD * BLDC + 2 * BTC * LDR
                         + 2 * BTC) * (int)sizeof(float);
    err = cudaFuncSetAttribute(swa_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
    if (err != cudaSuccess) return (int)err;
    swa_bwd_dkdv_kernel<HD><<<dim3(n_tiles, a.KV, a.B), THREADS, smem_kv,
                              a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.scratch, a.lengths, (float*)a.dk,
        (float*)a.dv, a.S, a.KV, a.G, a.window, a.scale);
    return (int)cudaGetLastError();
}

// fp32 (dtype 0): the SIMT body; bf16 (dtype 1): the tensor-core body
int bwd_dispatch(int hd, int dtype, const BwdArgs& a) {
#define SWA_BWD_CASE(HD)                                                    \
    case HD:                                                                \
        return dtype == 0 ? launch_bwd_simt<HD>(a) : launch_bwd_tc<HD>(a);
    switch (hd) {
        SWA_BWD_CASE(16)
        SWA_BWD_CASE(32)
        SWA_BWD_CASE(64)
        SWA_BWD_CASE(128)
        SWA_BWD_CASE(256)
        default: return (int)cudaErrorInvalidValue;
    }
#undef SWA_BWD_CASE
}

}  // namespace

// fp32 floats of scratch the backward needs: (B, S, KV, G) for D at fp32;
// at bf16 lse and D (2, B, KV G, S rounded up to 64) and dk / dv partials
// (2, G, B, S, KV, hd)
extern "C" long long swa_attn_bwd_scratch(int B, int S, int KV, int G, int hd,
                                          int dtype) {
    const long long H = (long long)KV * G;
    if (dtype == 0) return (long long)B * S * H;
    return 2 * B * H * round_rows(S) + 2LL * G * B * S * KV * hd;
}

// The backward: dq, dk, dv (the inputs' layouts and dtype) from q, k, v,
// the forward's output o and lse, and dout; scratch holds
// swa_attn_bwd_scratch fp32 floats.  Three launches on `stream` at fp32,
// four at bf16.
extern "C" int swa_attn_bwd_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   const int* lengths, void* dq, void* dk,
                                   void* dv, float* scratch, int B, int S,
                                   int KV, int G, int hd, int window,
                                   float scale, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || window <= 0)
        return (int)cudaErrorInvalidValue;
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    const BwdArgs a{q, k, v, o, lse, dout, lengths, dq, dk, dv, scratch, B,
                    S, KV, G, window, scale, (cudaStream_t)stream};
    return bwd_dispatch(hd, dtype, a);
}
