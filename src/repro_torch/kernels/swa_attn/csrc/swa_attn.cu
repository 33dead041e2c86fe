// Causal sliding-window attention, forward, for Hopper (sm_90a); bf16 or
// fp32 in and out, scale, mask and online softmax in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attn/kernel.py
// (swa_attn, body _swa_kernel), the TPU version of the band attention
// the reference's models run in XLA (models/attention.py:_mha_band).
// Query s attends to the keys in (s - window, s]:
//
//   o_s = sum_j softmax_j(scale * q_s . k_j) v_j,   s - window < j <= s
//
// with an online softmax (m, l, acc) over the key tiles, p kept in fp32
// for p . v (as swa_attn_ref and the TPU kernel), and the output written
// as acc / max(l, 1e-30) in q's dtype.  Given an lse buffer (B, S, KV, G)
// fp32, both bodies also write each row's m + log l (natural units; NEG,
// -1e30, for a row with no valid key), which the backward in
// swa_attn_bwd.cu reads; the output's bits do not depend on it.
//
// Layout: the port's, read in place.  q and o are (B, S, KV, G, hd), k
// and v (B, S, KV, hd); head h = kv * G + g reads its KV group's k and v
// without a repeat.  An optional lengths (B,) int32 marks row b's tokens
// at or past lengths[b] invalid: those keys are masked and those query
// rows are written as zeros.  Sums run in a fixed order and there are no
// atomics, so two launches on the same inputs agree bit for bit.
//
// What bounds it on this card: operations.  At the serving path's
// prefill shape (B 1, S 8192, 24 heads of 128, window 4096) the band
// holds 25.2M (query, key) pairs a head, 4 hd FLOP a pair: the
// function's 309 GFLOP take 0.31 ms at the bf16 tensor-core peak
// (989 TFLOP/s), against ~0.1 GB of q, k, v and o (0.03 ms at 3.35
// TB/s).  The bf16 body below spends 155 GFLOP more on the tensor cores
// than the function needs (464 in all, 0.47 ms at the peak), for the
// split of p described there.
//
// bf16 (the serving path), replacing the fp32 SIMT body of the first version
// (12.5 ms at that shape on an H100 80GB HBM3 at 700 W, 4.7x slower than
// PyTorch's SDPA under a band mask): the products run on the tensor cores
// with wgmma, bf16 in, fp32 accumulate, fed by TMA.  One block per (q tile
// of 192 rows, query head, batch): three consumer warpgroups of 64 q rows
// and one producer warp.  The q tiles go longest band first (the grid's
// slowest axis runs from the last q tile down), so the short bands at the
// start of the sequence fill the tail of the grid.  The producer walks the
// key tiles of 64 the block's window reaches and loads each K and V tile
// with TMA (cuTensorMapEncodeTiled looked up through the runtime, no
// -lcuda; boxes of 64 columns x 64 keys, 128-byte swizzle, keys past S and
// columns past hd read as zeros) into a ring of 4 stages, with a "full"
// mbarrier (TMA bytes) and an "empty" one (every consumer warp) a stage.
// The warpgroups then run apart from each other, so one's softmax overlaps
// another's products.  The q tile comes in once by cp.async in the same
// swizzled layout.  S = q k^T is wgmma m64n64k16 with both operands in
// shared memory, K-major; q and k are bf16, so each product is exact and the
// scores differ from an fp32 computation only in the order of the sum.
// Scale, mask and the online softmax (m, l) stay fp32 in registers; the mask
// is applied per element only where a warpgroup's 64 x 64 tile crosses the
// window's edges, the ragged S or a row's length (a masked score is -inf, so
// its p is exactly 0), interior tiles take no mask, and a warpgroup skips a
// tile that holds no valid pair.  p . v without rounding p to bf16: a bf16 p
// carries up to 2^-9 relative error in each term, which puts small outputs,
// where terms cancel, far over the one-bf16-ulp bar the kernel is held to;
// so p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), both A
// operands in registers of wgmma m64n{64,128}k16 against v in shared memory
// (MN-major), into one fp32 accumulator, leaving ~2^-17 relative error in p.
// That split is the 155 GFLOP above: p . v is half the function's work and
// runs twice.  Head dims below 64 are padded to 64 columns in shared memory
// (zeros). Shared memory at hd 128: 48 KB of q tile plus 4 x 32 KB of K/V
// stages, 177 KB, one block an SM.
//
// Head dim 256 (recurrentgemma-9b's MQA, 16 query heads over one KV head)
// takes smaller tiles (BandTile below): a q tile of 128 rows (two
// consumer warpgroups) and a ring of 2 K/V stages, 64 KB of q and 128 KB
// of K/V, 193 KB.  Three warpgroups would not fit their registers: a
// thread's p . v accumulator alone is 128 fp32 registers at hd 256, and
// 416 threads leave each at most 152; 288 threads leave 224.  Its p . v
// runs as two m64n128k16 products a 16-key step, one per 128 output
// columns, into the two halves of the accumulator.
//
// fp32 (the agreement phase and the tests): the first version's SIMT
// body, one block of 256 threads per (q tile of 64 rows, head, batch),
// fp32 FMAs, the q tile and each k / v tile staged in shared memory
// (87 KB at hd 128, two blocks an SM); thread (ty, tx) of a 16 x 16 grid
// owns rows 4 ty .. 4 ty + 3 and, for the scores, key columns 4 tx ..
// 4 tx + 3, for p . v the hd / 16 output columns tx + 16 c.
#include <cmath>

#include "hopper.cuh"

#define TQ 64
#define TK 64
#define THREADS 256
#define LDT (TQ + 4)        // row pitch of the transposed tiles (floats)

namespace {

constexpr float NEG = -1e30f;

// ---- fp32: SIMT ---------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS)
swa_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ lengths,
                float* __restrict__ o, float* __restrict__ lse, int S, int KV,
                int G, int window, float scale) {
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
    const float* qb = q + (size_t)b * S * q_row + (size_t)head * HD;
    float* ob = o + (size_t)b * S * q_row + (size_t)head * HD;
    const float* kb = k + (size_t)b * S * k_row + (size_t)kv * HD;
    const float* vb = v + (size_t)b * S * k_row + (size_t)kv * HD;

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
            Qt[d * LDT + r] = s < S ? qb[(size_t)s * q_row + d] : 0.0f;
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
                    s < S ? kb[(size_t)s * k_row + d] : 0.0f;
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
                    s < S ? vb[(size_t)s * k_row + d] : 0.0f;
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
        if (lse != nullptr && tx == 0)      // a row with no valid key: NEG
            lse[((size_t)b * S + s) * H + head] =
                li > 0.0f ? m[i] + logf(li) : NEG;
        const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
        for (int c = 0; c < DPT; ++c)
            ob[(size_t)s * q_row + tx + 16 * c] = acc[i][c] * inv;
    }
}

// ---- bf16: wgmma, K/V by TMA from a producer warp ----------------------

// the bf16 body's tiles at head dim HD: consumer warpgroups of 64 q rows
// each, and K/V stages in the ring (smaller at hd 256, see above)
template <int HD>
struct BandTile {
    static constexpr int NWG = HD > 128 ? 2 : 3;
    static constexpr int BQ = 64 * NWG;             // q rows a block
    static constexpr int STAGES = HD > 128 ? 2 : 4;
    static constexpr int NTHREADS = 128 * NWG + 32; // + 1 producer warp
};

// 16 bytes global -> shared, zero-filled when !valid (src must still be
// a valid address; nothing is read from it then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// byte offset of 16-byte chunk c of row r in a tile of `rows` rows laid
// out as 128-byte-swizzle atoms: 64 columns (128 bytes) a row, the atoms
// of a row's next 64 columns after all rows of the first
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
    return (uint32_t)((c >> 3) * rows * 128 + r * 128
                      + (((c & 7) ^ (r & 7)) << 4));
}

template <int HD>
__global__ void __launch_bounds__(BandTile<HD>::NTHREADS, 1)
swa_attn_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const bf16* __restrict__ q,
                     const int* __restrict__ lengths, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int KV, int G,
                     int window, float scale_log2) {
    constexpr int NWG = BandTile<HD>::NWG;
    constexpr int BQ = BandTile<HD>::BQ;
    constexpr int KV_STAGES = BandTile<HD>::STAGES;
    constexpr int TC_THREADS = BandTile<HD>::NTHREADS;
    constexpr int HDP = HD < 64 ? 64 : HD;  // columns in shared (padded)
    constexpr int NA = HDP / 64;            // 128-byte atoms a row
    constexpr int CH = HD / 8;              // 16-byte chunks a row
    constexpr int CHP = HDP / 8;
    constexpr int NO = HDP / 2;             // output accumulators a thread
    constexpr uint32_t Q_BYTES = BQ * HDP * 2;
    constexpr uint32_t KV_BYTES = BN * HDP * 2;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t ks = qs + Q_BYTES;       // [KV_STAGES] K tiles
    const uint32_t vs = ks + KV_STAGES * KV_BYTES;
    const uint32_t full = vs + KV_STAGES * KV_BYTES;   // [KV_STAGES] mbarriers
    const uint32_t empty = full + 8 * KV_STAGES;       // [KV_STAGES]

    const int head = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest first
    const int kv = head / G;
    const int H = KV * G;
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int n = lengths ? min(lengths[b], S) : S;

    const size_t q_row = (size_t)H * HD;
    const bf16* qb = q + (size_t)b * S * q_row + (size_t)head * HD;
    bf16* ob = o + (size_t)b * S * q_row + (size_t)head * HD;

    if (q0 >= n) {
        const uint4 zero = make_uint4(0, 0, 0, 0);
        for (int e = tid; e < BQ * CH; e += TC_THREADS) {
            const int s = q0 + e / CH;
            if (s < S)
                *reinterpret_cast<uint4*>(ob + (size_t)s * q_row
                                          + (e % CH) * 8) = zero;
        }
        if (lse != nullptr)
            for (int r = tid; r < BQ; r += TC_THREADS)
                if (q0 + r < S) lse[((size_t)b * S + q0 + r) * H + head] = NEG;
        return;
    }
    const int q_last = min(q0 + BQ, n) - 1;
    const int kt_lo = max(0, q0 - window + 1) / BN;
    const int n_tiles = q_last / BN - kt_lo + 1;

    if (tid == 0) {
        for (int st = 0; st < KV_STAGES; ++st) {
            mbar_init(full + 8 * st, 1);    // the producer's expect_tx
            mbar_init(empty + 8 * st, 4 * NWG);   // every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 4 * NWG) {                  // the producer warp
        if (lane == 0) {
            for (int i = 0; i < n_tiles; ++i) {
                const int st = i % KV_STAGES;
                if (i >= KV_STAGES)         // read in round i / stages - 1
                    mbar_wait(empty + 8 * st, (i / KV_STAGES - 1) & 1);
                mbar_expect_tx(full + 8 * st, 2 * KV_BYTES);
                const int k0 = (kt_lo + i) * BN;
#pragma unroll
                for (int a = 0; a < NA; ++a) {
                    tma_load_4d(ks + st * KV_BYTES + a * BN * 128, &kmap,
                                full + 8 * st, a * 64, kv, k0, b);
                    tma_load_4d(vs + st * KV_BYTES + a * BN * 128, &vmap,
                                full + 8 * st, a * 64, kv, k0, b);
                }
            }
        }
        return;
    }

    // consumers: the q tile by cp.async, swizzled as the TMA boxes are
    for (int e = tid; e < BQ * CHP; e += 128 * NWG) {
        const int r = e / CHP, c = e % CHP;
        const int s = q0 + r;
        cp_async16(qs + swz(r, c, BQ),
                   qb + (size_t)min(s, S - 1) * q_row + min(c, CH - 1) * 8,
                   s < S && c < CH);
    }
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * NWG) : "memory");

    // this thread's rows: g and g + 8 of its warp's 16 in its warpgroup's 64
    const int gq = lane >> 2;
    const int tq = lane & 3;
    const int wq0 = q0 + wg * 64;           // the warpgroup's first q row
    const int rows[2] = {wq0 + (warp % 4) * 16 + gq,
                         wq0 + (warp % 4) * 16 + gq + 8};
    float acc[NO];
#pragma unroll
    for (int d = 0; d < NO; ++d) acc[d] = 0.0f;
    float m[2] = {NEG, NEG};
    float l[2] = {0.0f, 0.0f};

    for (int i = 0; i < n_tiles; ++i) {
        const int st = i % KV_STAGES;
        mbar_wait(full + 8 * st, (i / KV_STAGES) & 1);
        const int k0 = (kt_lo + i) * BN;
        // a tile with no valid pair for the warpgroup's 64 rows
        if (k0 > wq0 + 63 || k0 >= n || wq0 >= n
            || wq0 - (k0 + BN - 1) >= window) {
            if (lane == 0) mbar_arrive(empty + 8 * st);
            continue;
        }
        const bool interior = k0 + BN - 1 <= wq0
                              && wq0 + 63 - k0 < window
                              && k0 + BN <= n && wq0 + 64 <= n;
        const uint32_t kt = ks + st * KV_BYTES;
        const uint32_t vt = vs + st * KV_BYTES;

        // S = q k^T: A = q (K-major), B = k (K-major), 16 columns a step
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
        wgmma_fence();
        fence_regs(sc);
#pragma unroll
        for (int c = 0; c < HD / 16; ++c)
            wgmma_ss_n64(sc,
                         smem_desc(qs + (c / 4) * BQ * 128 + wg * 64 * 128
                                   + (c % 4) * 32, 16, 1024),
                         smem_desc(kt + (c / 4) * BN * 128 + (c % 4) * 32,
                                   16, 1024), c > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // scale (log2 units), mask, online softmax; sc[4 j + e] is row
        // rows[e / 2], key k0 + 8 j + 2 tq + e % 2
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = sc[4 * j + e] * scale_log2;
                if (!interior) {
                    const int qp = rows[e >> 1];
                    const int kp = k0 + j * 8 + 2 * tq + (e & 1);
                    if (!(qp < n && kp < n && kp <= qp && qp - kp < window))
                        x = -INFINITY;
                }
                sc[4 * j + e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            alpha[r] = exp2f(m[r] - m_new);
            m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const float p = exp2f(sc[j] - m[(j >> 1) & 1]);
            sc[j] = p;
            rs[(j >> 1) & 1] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int d = 0; d < NO; ++d) acc[d] *= alpha[(d >> 1) & 1];

        // acc += p_hi . v, then p_lo . v: A = p in registers, B = v
        // (MN-major), 16 keys a step
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            split_p(sc[8 * kk + 0], sc[8 * kk + 1], ph[kk][0], pl[kk][0]);
            split_p(sc[8 * kk + 2], sc[8 * kk + 3], ph[kk][1], pl[kk][1]);
            split_p(sc[8 * kk + 4], sc[8 * kk + 5], ph[kk][2], pl[kk][2]);
            split_p(sc[8 * kk + 6], sc[8 * kk + 7], ph[kk][3], pl[kk][3]);
        }
        wgmma_fence();
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint64_t dv = smem_desc(vt + kk * 16 * 128,
                                              BN * 128, 1024);
                if constexpr (HDP == 256) {
                    // columns 0-127, then 128-255 (two atoms on)
                    wgmma_rs_n128<0>(acc, half ? pl[kk] : ph[kk], dv);
                    wgmma_rs_n128<64>(acc, half ? pl[kk] : ph[kk],
                                      smem_desc(vt + 2 * BN * 128
                                                + kk * 16 * 128, BN * 128,
                                                1024));
                } else if constexpr (HDP == 128) {
                    wgmma_rs_n128<0>(acc, half ? pl[kk] : ph[kk], dv);
                } else {
                    wgmma_rs_n64(acc, half ? pl[kk] : ph[kk], dv);
                }
            }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
        if (lane == 0) mbar_arrive(empty + 8 * st);    // stage read
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const float den = fmaxf(lr, 1e-30f);
        const int s = rows[r];
        if (s >= S) continue;
        // m is in log2 units: lse = (m + log2 l) ln 2
        if (lse != nullptr && tq == 0)
            lse[((size_t)b * S + s) * H + head] =
                lr > 0.0f ? (m[r] + log2f(lr)) * 0.6931471805599453f : NEG;
        bf16* orow = ob + (size_t)s * q_row + 2 * tq;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
            *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
                __floats2bfloat162_rn(acc[4 * d + 2 * r] / den,
                                      acc[4 * d + 2 * r + 1] / den);
    }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const int* lengths, void* o, float* lse, int B, int S, int KV,
                int G, int window, float scale, cudaStream_t stream) {
    constexpr int HDP = HD < 64 ? 64 : HD;
    constexpr int BQ = BandTile<HD>::BQ;
    constexpr int KV_STAGES = BandTile<HD>::STAGES;
    const int smem = 1024 + (BQ + 2 * KV_STAGES * BN) * HDP * 2
                     + 16 * KV_STAGES;
    const int n_qt = (S + BQ - 1) / BQ;
    if (B > 65535 || n_qt > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap kmap, vmap;
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0    // q rows by cp.async
        || !bshd_map(&kmap, k, B, S, KV, HD) || !bshd_map(&vmap, v, B, S, KV, HD))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        swa_attn_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(KV * G, B, n_qt);
    swa_attn_bf16_kernel<HD><<<grid, BandTile<HD>::NTHREADS, smem, stream>>>(
        kmap, vmap, (const bf16*)q, lengths, (bf16*)o, lse, S, KV, G, window,
        scale * 1.4426950408889634f);
    return (int)cudaGetLastError();
}

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v,
                const int* lengths, void* o, float* lse, int B, int S, int KV,
                int G, int window, float scale, cudaStream_t stream) {
    const int smem = (2 * HD * LDT + TK * LDT) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        swa_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + TQ - 1) / TQ, KV * G, B);
    swa_attn_kernel<HD><<<grid, THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, lengths, (float*)o,
        lse, S, KV, G, window, scale);
    return (int)cudaGetLastError();
}

int dispatch_hd(int hd, int dtype, const void* q, const void* k,
                const void* v, const int* lengths, void* o, float* lse, int B,
                int S, int KV, int G, int window, float scale,
                cudaStream_t stream) {
#define SWA_CASE(HD)                                                        \
    case HD:                                                                \
        return dtype == 0                                                   \
            ? launch_fp32<HD>(q, k, v, lengths, o, lse, B, S, KV, G,        \
                               window, scale, stream)                       \
            : launch_bf16<HD>(q, k, v, lengths, o, lse, B, S, KV, G,        \
                              window, scale, stream);
    switch (hd) {
        SWA_CASE(16)
        SWA_CASE(32)
        SWA_CASE(64)
        SWA_CASE(128)
        SWA_CASE(256)
        default: return (int)cudaErrorInvalidValue;
    }
#undef SWA_CASE
}

}  // namespace

// dtype 0: fp32, 1: bf16.  lengths may be null (every row holds S); lse
// (B, S, KV, G) fp32 may be null (not written).
extern "C" int swa_attn_launch(const void* q, const void* k, const void* v,
                               const int* lengths, void* o, float* lse, int B,
                               int S, int KV, int G, int hd, int window,
                               float scale, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || window <= 0)
        return (int)cudaErrorInvalidValue;
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    return dispatch_hd(hd, dtype, q, k, v, lengths, o, lse, B, S, KV, G,
                       window, scale, (cudaStream_t)stream);
}
