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
// FLOPs (plus 2 n V k2 for p.R2) against 4 d V bytes of W, ~n/2 FLOPs per
// byte.  The reference computes in fp32, and TF32 alone keeps ~3 decimal
// digits, so the tensor cores run the products as 3xTF32: each operand x
// is split into hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest, and lo.hi + hi.lo + hi.hi go into an fp32 accumulator (lo.lo,
// ~2^-22 of the product, is dropped).  That is 3 x 2 n d V FLOPs at the
// TF32 peak of 495 TFLOP/s against 2 n d V at the fp32 FMA peak of 67:
// the 3xTF32 route's bound is about 0.4 of the fp32 one.  W is never
// split in device memory (a split copy of the head would cost 0.6-0.7
// GB).
//
// Design:
// - gs_partial: a block of two warpgroups owns 128 rows of one unit (64 a
//   warpgroup) and one contiguous split of the vocab's 128-column tiles.
//   h and W come in 32-wide K slices through a 3-stage cp.async ring
//   (16-byte copies when d % 4 == 0 and the rows are 16-byte aligned,
//   else 4-byte ones).  Each slice of W is split once, by all threads,
//   into TF32 hi and lo planes laid out as wgmma reads them (K-major,
//   128-byte swizzle); each warp splits its own 16 rows of h in registers.
//   Three wgmma.m64n128k8 a k8 step (A = h from registers, B = W from
//   shared memory) put the slice's 12 products into an accumulator of
//   their own, which is added to the tile's fp32 accumulator once the
//   slice completes: the tensor cores' accumulation (not IEEE rounding)
//   then runs over 12 products, not all of d.  With one running
//   accumulator the kernel sat several times farther from a float64
//   sketch than cuBLAS's fp32 plain version; with one a slice it sits
//   nearer (chip_smoke.py prints both distances).  W's plane pairs are
//   double buffered: the next slice lands and is split while this one's
//   wgmma runs.  Values are rounded to TF32 with two integer operations on
//   their bits: the cvt.rna.tf32.f32 instruction (~70 a thread a slice)
//   runs on a slower pipe and held the loop back.
// - The epilogue of a tile runs the online softmax on the accumulator and
//   p.R2 on mma.sync straight from it: the accumulator holds columns (2t,
//   2t+1) where an m16n8k8 A fragment wants (t, t+4), so k slot t takes
//   column 2t and slot t+4 column 2t+1, and R2's rows are read in that
//   order.  p splits in two and R2 in three (p_hi R2 is then exact, so a
//   one-column vocab gives er2 = 0 exactly).  R2's 128 x 64 chunk comes
//   in with the tile's first slice.  k2 above 64 is cut into 64-column
//   chunks over the grid (each recomputes the logits; the main paths have
//   k2 = 64).
// - The vocab split is a function of the shapes only (ops.py:
//   vocab_splits), so a launch's bits do not depend on the card.
// - gs_merge merges a row's partials (one a split) in split order (M =
//   max m, S = sum s e^{m - M}, er2 = sum er2_part e^{m - M} / max(S,
//   1e-30) - rvt, times scale); gs_contract sums hr^T er2 over 128-row
//   slabs, rows in order; gs_sum adds the slabs in slab order.  No atomics
//   anywhere, so two launches on the same inputs give the same bits.
//
// Tried and dropped: the first port was an fp32 SIMT GEMM of
// 64 x 64 tiles, BK 16, 4 x 4 accumulators a thread, scalar loads with no
// double buffering, p.R2 in SIMT through shared memory, and a single
// block merging every row's splits: ~14.5 TFLOP/s, 43.6 ms at the LM
// unit on an H100, 3.2x its own cuBLAS-backed plain version.  Then, neither faster
// than the plain version: mma.sync.m16n8k8 3xTF32 in 4 x 2 warps of 32 x
// 64 (every warp re-split its B fragments, ~3 instructions of splitting
// a tensor instruction), and wgmma with one accumulator over all of d
// and a wait a slice (its R2 chunk staged through registers and its p.R2
// loop not unrolled, so the accumulator lived in local memory).
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 128          // rows of a block: two warpgroups of 64
#define BN 128          // vocab columns a tile: one wgmma n128
#define BK 32           // K slice of a pipeline stage: one 128-byte row
#define KC 64           // k2 columns a block accumulates
#define STAGES 3
#define THREADS 256
#define LDT (BK + 4)    // padded raw staged row (floats): 144 bytes
#define LDR 68          // padded staged R2 row (floats): 272 bytes
#define SLAB 128        // rows of one gs_contract block
#define FR 16
#define NEG (-1e30f)
#define PLANE (128 * BK * 4)   // bytes of one TF32 plane of W's slice
#define PLANES (2 * PLANE)      // its hi and lo planes

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// tf32(x), rounded to nearest with ties away from zero (cvt.rna.tf32.f32)
// as two integer operations on the bits: add half of the 13 dropped bits'
// range to the magnitude, then clear them.  The conversion instruction
// runs on a slower pipe, and the kernel rounds ~70 values a thread a K
// slice.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, hi = tf32(x), lo = tf32(x - hi): the two TF32 operands of
// the 3xTF32 product
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// x = hi + mid + lo exactly, each a TF32 value (11 + 11 + 11 significant
// bits cover fp32's 24)
__device__ __forceinline__ void split3_tf32(float x, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
    hi = tf32_rna(x);
    const float r = x - __uint_as_float(hi);
    mid = tf32_rna(r);
    lo = tf32_rna(r - __uint_as_float(mid));
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


__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving register reads or writes across an
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
           | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// byte offset of 16-byte chunk c (of 8) of row r in a K-major tile of
// 128-byte rows in 128-byte-swizzle atoms
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// d (m64 n128, fp32) (+)= a . b: a (TF32 bits) in registers, b (TF32
// bits, K-major) in shared memory; d is overwritten when !acc
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// One BK-wide K slice [k0, k0 + BK) of rows [r0, r0 + 128) of a row-major
// (rows, d) matrix into a padded (128, LDT) panel, zero outside the
// matrix; VEC: 16-byte copies (d % 4 == 0, 16-byte aligned rows).
template <bool VEC>
__device__ __forceinline__ void stage_panel(float* S, const float* a,
                                            int r0, int rows, int k0, int d,
                                            int tid) {
    if (VEC) {
#pragma unroll
        for (int l = 0; l < (128 * BK / 4) / THREADS; ++l) {
            const int e = tid + l * THREADS;
            const int r = e >> 3, c = (e & 7) * 4;
            const bool ok = r0 + r < rows && k0 + c < d;
            cp_async16(S + r * LDT + c,
                       ok ? a + (size_t)(r0 + r) * d + k0 + c : a, ok);
        }
    } else {
#pragma unroll 4
        for (int l = 0; l < (128 * BK) / THREADS; ++l) {
            const int e = tid + l * THREADS;
            const int r = e >> 5, c = e & 31;
            const bool ok = r0 + r < rows && k0 + c < d;
            cp_async4(S + r * LDT + c,
                      ok ? a + (size_t)(r0 + r) * d + k0 + c : a, ok);
        }
    }
}

// Per block (split, 128-row tile, unit and 64-column k2 chunk): one walk
// over the split's vocab tiles.  Warpgroup wg owns rows wg*64.. of the
// tile and all 128 columns; in it, warp w's lane (g = lane >> 2, t = lane
// & 3) holds rows 16 w + g and 16 w + g + 8 and, per 8-column block j,
// the accumulator entries 4 j + {0, 1} (row g, columns 8 j + 2t, + 1) and
// 4 j + {2, 3} (row g + 8).  The 4 lanes of a row agree on its running
// max by shuffles; each keeps its own share of the running sum.  Per K
// slice: the raw slices land by cp.async; W's is split once into TF32 hi
// and lo planes (128-byte swizzle, as wgmma reads them) by all threads,
// h's in registers by each warp for its own rows; then three wgmma a k8
// step.  Partial q = the split.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
gs_partial(const float* __restrict__ h, const float* __restrict__ wt,
           const float* __restrict__ r_v, float* __restrict__ m_part,
           float* __restrict__ s_part, float* __restrict__ er2_part, int n,
           int d, int V, int k2, int tiles_per_split, int k2_chunks) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base =
        smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    // two pairs of W's (hi, lo) planes [128][32], then the raw rings
    const uint32_t bh_addr = smem_u32(base);
    float* As = reinterpret_cast<float*>(base + 2 * PLANES);
    float* Bs = As + STAGES * 128 * LDT;           // raw [STAGES][128][LDT]
    float* Rs = Bs + STAGES * 128 * LDT;           // R2 chunk [128][LDR]
    const int split = blockIdx.x;
    const int r0 = blockIdx.y * BM;
    const int u = blockIdx.z / k2_chunks;
    const int j0 = (blockIdx.z % k2_chunks) * KC;
    const int U = gridDim.z / k2_chunks;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;   // the warp's rows
    const float* hu = h + (size_t)u * n * d;
    const int n_tiles = (V + BN - 1) / BN;
    const int t0 = split * tiles_per_split;
    const int t1 = min(t0 + tiles_per_split, n_tiles);
    const int nK = (d + BK - 1) / BK;
    const int total = (t1 - t0) * nK;

    float acc[64];
    float er2[32];
    float m[2] = {NEG, NEG}, s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 32; ++j) er2[j] = 0.0f;

    // the flat stream of (vocab tile, K slice) stages
    auto load = [&](int it) {
        const int slot = it % STAGES;
        const int c0 = (t0 + it / nK) * BN;
        const int k0 = (it % nK) * BK;
        stage_panel<VEC>(As + slot * 128 * LDT, hu, r0, n, k0, d, tid);
        stage_panel<VEC>(Bs + slot * 128 * LDT, wt, c0, V, k0, d, tid);
    };
    // W's slice it into plane pair it & 1, 4 floats a step
    auto split_w = [&](int it) {
        const float* braw = Bs + (it % STAGES) * 128 * LDT;
        unsigned char* plane = base + (it & 1) * PLANES;
#pragma unroll
        for (int l = 0; l < (128 * BK / 4) / THREADS; ++l) {
            const int e = tid + l * THREADS;
            const int r = e >> 3, c = e & 7;
            const float4 x =
                *reinterpret_cast<const float4*>(braw + r * LDT + 4 * c);
            uint4 hi, lo;
            split_tf32(x.x, hi.x, lo.x);
            split_tf32(x.y, hi.y, lo.y);
            split_tf32(x.z, hi.z, lo.z);
            split_tf32(x.w, hi.w, lo.w);
            *reinterpret_cast<uint4*>(plane + swz(r, c)) = hi;
            *reinterpret_cast<uint4*>(plane + PLANE + swz(r, c)) = lo;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < total) load(st);
        cp_async_commit();
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    split_w(0);
    __syncthreads();

    for (int it = 0; it < total; ++it) {
        // raw slice it landed and plane pair it & 1 holds its W split
        const int kt = it % nK;
        if (kt == 0) {
#pragma unroll
            for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
        }
        // h's fragments of the warp's 16 rows, the slice's 4 k8 steps
        const float* ap = As + (it % STAGES) * 128 * LDT + (wrow + g) * LDT
                          + t;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            split_tf32(ap[8 * kk], ah[kk][0], al[kk][0]);
            split_tf32(ap[8 * LDT + 8 * kk], ah[kk][1], al[kk][1]);
            split_tf32(ap[8 * kk + 4], ah[kk][2], al[kk][2]);
            split_tf32(ap[8 * LDT + 8 * kk + 4], ah[kk][3], al[kk][3]);
        }
        // the slice into its own accumulator sl (the first product
        // overwrites it), added to acc in fp32 once it completes: the
        // tensor cores' accumulation runs over 12 products, not all of d
        const uint32_t pa = bh_addr + (it & 1) * PLANES;
        float sl[64];
        wgmma_fence();
        fence_regs(sl);
        fence_regs(ah);
        fence_regs(al);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dh = smem_desc(pa + kk * 32, 16, 1024);
            const uint64_t dl = smem_desc(pa + PLANE + kk * 32, 16, 1024);
            wgmma_tf32(sl, al[kk], dh, kk > 0);
            wgmma_tf32(sl, ah[kk], dl, 1);
            wgmma_tf32(sl, ah[kk], dh, 1);
        }
        wgmma_commit();
        // while it runs: the next raw slices, and the next W split into the
        // other plane pair (its last reader, slice it - 1, has completed)
        if (kt == 0) {
            // R2's rows of this tile, columns [j0, j0 + 64): every warp is
            // past the previous tile's p.R2
            const int c0 = (t0 + it / nK) * BN;
#pragma unroll 8
            for (int l = 0; l < (BN * KC) / THREADS; ++l) {
                const int e = tid + l * THREADS;
                const int vv = e >> 6, jj = e & 63;
                const bool ok = c0 + vv < V && j0 + jj < k2;
                cp_async4(Rs + vv * LDR + jj,
                          ok ? r_v + (size_t)(c0 + vv) * k2 + j0 + jj : r_v,
                          ok);
            }
        }
        if (it + STAGES - 1 < total) load(it + STAGES - 1);
        cp_async_commit();
        if (it + 1 < total) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();
            split_w(it + 1);
        }
        wgmma_wait<0>();
        fence_regs(sl);
        fence_regs(ah);
        fence_regs(al);
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += sl[j];
        if (kt != nK - 1) {
            __syncthreads();
            continue;
        }

        // -- epilogue of vocab tile c0: online softmax, then p.R2 -------
        const int c0 = (t0 + it / nK) * BN;
        const int cw = c0 + 2 * t;                 // + 8 j + {0, 1}
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            float tmax = NEG;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int q = 0; q < 2; ++q)
                    if (cw + 8 * j + q < V)
                        tmax = fmaxf(tmax, acc[4 * j + 2 * hf + q]);
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
            const float mn = fmaxf(m[hf], tmax);
            const float alpha = expf(m[hf] - mn);
            float add = 0.0f;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    float& a = acc[4 * j + 2 * hf + q];
                    a = (cw + 8 * j + q < V) ? expf(a - mn) : 0.0f;
                    add += a;
                }
            s[hf] = s[hf] * alpha + add;
            m[hf] = mn;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                er2[4 * j + 2 * hf] *= alpha;
                er2[4 * j + 2 * hf + 1] *= alpha;
            }
        }
        // R2's chunk came in the group of the tile's first slice: wait for
        // every group (once a tile), so also when the tile has one slice
        cp_async_wait<0>();
        __syncthreads();
        // er2 (16 x 64 of this warp) += p (16 x 128) . R2 (128 x 64) on
        // mma.sync: the accumulator holds columns (2t, 2t + 1) of block ks
        // where an m16n8k8 A fragment wants (t, t + 4), so k slot t takes
        // column 2t and slot t + 4 column 2t + 1, R2's rows in that order.
        // p splits in two, R2 in three (p_hi R2 is then exact: a p of
        // exactly 1, a one-column vocab, gives er2 = R2[t] - R2[t] = 0)
        const float* Rp = Rs + (2 * t) * LDR + g;
#pragma unroll
        for (int ks = 0; ks < 16; ++ks) {
            uint32_t ph[4], pl[4];
            split_tf32(acc[4 * ks], ph[0], pl[0]);
            split_tf32(acc[4 * ks + 2], ph[1], pl[1]);
            split_tf32(acc[4 * ks + 1], ph[2], pl[2]);
            split_tf32(acc[4 * ks + 3], ph[3], pl[3]);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                uint32_t bh[2], bm[2], bl[2];
                split3_tf32(Rp[ks * 8 * LDR + 8 * j], bh[0], bm[0], bl[0]);
                split3_tf32(Rp[ks * 8 * LDR + LDR + 8 * j], bh[1], bm[1],
                            bl[1]);
                mma_tf32(er2 + 4 * j, ph, bl);
                mma_tf32(er2 + 4 * j, ph, bm);
                mma_tf32(er2 + 4 * j, pl, bh);
                mma_tf32(er2 + 4 * j, ph, bh);
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        float sum = s[hf];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int row = r0 + wrow + hf * 8 + g;
        if (row >= n) continue;
        const size_t o = ((size_t)split * U + u) * n + row;
        if (j0 == 0 && t == 0) {
            m_part[o] = m[hf];
            s_part[o] = sum;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int col = j0 + 8 * j + 2 * t + c;
                if (col < k2)
                    er2_part[o * k2 + col] = er2[4 * j + 2 * hf + c];
            }
    }
}

// er2[u][row][j] from the Q partials of its row, merged in partial order:
// M = max m, S = sum s e^{m - M}, er2 = (sum er2_part e^{m - M}) /
// max(S, 1e-30) - rvt, times scale.  One thread an entry.
__global__ void __launch_bounds__(THREADS)
gs_merge(const float* __restrict__ rvt, const float* __restrict__ scale,
         const float* __restrict__ m_part, const float* __restrict__ s_part,
         const float* __restrict__ er2_part, float* __restrict__ er2,
         int U, int n, int k2, int Q) {
    const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
    const size_t rows = (size_t)U * n;
    if (e >= rows * k2) return;
    const size_t ur = e / k2;                      // u * n + row
    const int j = (int)(e % k2);
    float mx = NEG;
    for (int qq = 0; qq < Q; ++qq) mx = fmaxf(mx, m_part[qq * rows + ur]);
    float sum = 0.0f, acc = 0.0f;
    for (int qq = 0; qq < Q; ++qq) {
        const float w = expf(m_part[qq * rows + ur] - mx);
        sum += s_part[qq * rows + ur] * w;
        acc += er2_part[(qq * rows + ur) * k2 + j] * w;
    }
    er2[e] = (acc * (1.0f / fmaxf(sum, 1e-30f)) - rvt[e]) * scale[ur];
}

// part[slab][u][a][j] = sum over the slab's rows, in order, of
// hr[u][row][a] er2[u][row][j]: a 64 x 64 output tile a block.
__global__ void __launch_bounds__(THREADS)
gs_contract(const float* __restrict__ hr, const float* __restrict__ er2,
            float* __restrict__ part, int U, int n, int k1, int k2,
            int k1_tiles) {
    __shared__ float Hs[FR][64 + 1];
    __shared__ float Gs[FR][64 + 1];
    const int j0 = blockIdx.x * 64;
    const int a0 = (blockIdx.y % k1_tiles) * 64;
    const int u = blockIdx.y / k1_tiles;
    const int slab = blockIdx.z;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int rbeg = slab * SLAB, rend = min(rbeg + SLAB, n);

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int n0 = rbeg; n0 < rend; n0 += FR) {
#pragma unroll
        for (int l = 0; l < (FR * 64) / THREADS; ++l) {
            const int e = tid + l * THREADS;
            const int r = e / 64, c = e % 64;
            const int row = n0 + r;
            const size_t ur = (size_t)u * n + row;
            const bool live = row < rend;
            Hs[r][c] = (live && a0 + c < k1) ? hr[ur * k1 + a0 + c] : 0.0f;
            Gs[r][c] = (live && j0 + c < k2) ? er2[ur * k2 + j0 + c] : 0.0f;
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
            if (jj < k2)
                part[(((size_t)slab * U + u) * k1 + a) * k2 + jj] = acc[i][j];
        }
    }
}

// out = the slabs' partial sketches added in slab order
__global__ void __launch_bounds__(THREADS)
gs_sum(const float* __restrict__ part, float* __restrict__ out, int size,
       int slabs) {
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= size) return;
    float acc = 0.0f;
    for (int sl = 0; sl < slabs; ++sl) acc += part[(size_t)sl * size + e];
    out[e] = acc;
}

}  // namespace

// The four kernels in order on ``stream``; returns the first launch error
// (cudaSuccess = 0).  Scratch, all written before it is read: m_part,
// s_part (S, U, n); er2_part (S, U, n, k2); er2 (U, n, k2); part
// (ceil(n / 128), U, k1, k2).
extern "C" int grad_sketch_units_launch(
    const float* h, const float* wt, const float* r_v, const float* hr,
    const float* rvt, const float* scale, float* m_part, float* s_part,
    float* er2_part, float* er2, float* part, float* out, int U, int n,
    int d, int V, int k1, int k2, int S, int tiles_per_split,
    void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    // two pairs of W's hi and lo planes, the raw h and W rings, R2's
    // chunk, and room to align the planes to 1024 bytes
    const int dyn = 2 * PLANES + (2 * STAGES * 128 * LDT + 128 * LDR)
                    * (int)sizeof(float) + 1024;
    const bool vec = d % 4 == 0 && (uintptr_t)h % 16 == 0
                     && (uintptr_t)wt % 16 == 0;
    const int k2_chunks = (k2 + KC - 1) / KC;
    const dim3 grid(S, (n + BM - 1) / BM, U * k2_chunks);
    cudaError_t err;
    if (vec) {
        err = cudaFuncSetAttribute(gs_partial<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   dyn);
        if (err != cudaSuccess) return (int)err;
        gs_partial<true><<<grid, THREADS, dyn, st>>>(
            h, wt, r_v, m_part, s_part, er2_part, n, d, V, k2,
            tiles_per_split, k2_chunks);
    } else {
        err = cudaFuncSetAttribute(gs_partial<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   dyn);
        if (err != cudaSuccess) return (int)err;
        gs_partial<false><<<grid, THREADS, dyn, st>>>(
            h, wt, r_v, m_part, s_part, er2_part, n, d, V, k2,
            tiles_per_split, k2_chunks);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t entries = (size_t)U * n * k2;
    gs_merge<<<(unsigned)((entries + THREADS - 1) / THREADS), THREADS, 0,
               st>>>(rvt, scale, m_part, s_part, er2_part, er2, U, n, k2,
                     S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int k1_tiles = (k1 + 63) / 64;
    const int slabs = (n + SLAB - 1) / SLAB;
    const dim3 grid3((k2 + 63) / 64, U * k1_tiles, slabs);
    gs_contract<<<grid3, THREADS, 0, st>>>(hr, er2, part, U, n, k1, k2,
                                           k1_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int size = U * k1 * k2;
    gs_sum<<<(size + THREADS - 1) / THREADS, THREADS, 0, st>>>(part, out,
                                                               size, slabs);
    return (int)cudaGetLastError();
}
