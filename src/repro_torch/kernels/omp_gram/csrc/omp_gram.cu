// Batched Gram matrix K_p = G_p G_p^T for Hopper (sm_90a), fp32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/omp_gram/kernel.py
// (omp_gram_batched, body _gram_kernel; omp_gram is its P = 1 case): the
// stage-B Gram of every partition, accumulated in fp32 over D with the
// ragged n and D edges zero-padded.
//
// What bounds it on this card: at stage B's n (4 rows a partition on the
// smoke corpus) nothing but latency: 0.5 MFLOP and 0.26 MB, a few
// microseconds of launch.  From n in the hundreds, operations: the
// upper triangle's P n (n + 1) D FLOPs against 4 P n D bytes read is
// about n / 4 FLOPs a byte, above the fp32 ridge of ~20 FLOP/byte.  The products stay in fp32 FMA, off the
// tensor cores (no TF32): the reference computes this Gram in full fp32.
//
// Design, replacing one 64 x 64 tile a block over all of D (the first
// version: 0.25 ms at (4, 4, 4096) on an H100 80GB HBM3 at 700 W, where
// torch.bmm takes 0.07 ms):
// - Upper-triangle tiles only.  Block x = t walks the tiles (ti, tj), ti
//   <= tj, row by row; each tile is written with its mirror, K[c, r] the
//   same bits as K[r, c] (inside a diagonal tile only r <= c is taken),
//   so K is exactly symmetric and half the work goes.
// - Tiles sized to n (the wrapper's plan, ops.py:gram_plan): 32 x 32
//   (2 x 2 a thread) for n <= 32, else 128 x 128 (8 x 8 register
//   micro-tiles), 256 threads each.  A thread owns rows 4 ty + {0..3}
//   and 64 + 4 ty + {0..3} (128) or 2 ty + {0, 1} (32), the same for its
//   columns by tx, so its reads of both panels are float4 / float2
//   vectors and a warp's are conflict-free or broadcast.
// - Split over D when the tiles cannot fill the card.  Block y = split
//   sums one D slice (a multiple of BK) of its tile; with one split it
//   writes K itself, else it writes a partial tile into the wrapper's
//   scratch buffer and omp_gram_reduce_kernel adds the partials in split
//   order, one block a 32 x 32 block of a tile, through shared memory so
//   that the mirror is written by rows too.  No atomics: two launches
//   agree bit for bit.
// - BK = 32 columns of both row panels come in by cp.async, double
//   buffered with one barrier a step: the next step's copies are in
//   flight while the current one is multiplied.  The copies are 4 bytes
//   each (any D, any row offset; a warp copies 128 contiguous bytes of
//   one row), written transposed into [BK][tile + 4] panels in dynamic
//   shared memory (68 KB at tile 128, two blocks an SM).  A diagonal tile
//   loads one panel.
// Block z = partition.  Loads outside n or the slice are zero-filled,
// stores outside n masked.
#include <cuda_runtime.h>

#define BK 32               // D columns a pipeline step
#define STAGES 2            // steps in flight
#define THREADS 256

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the i-th of a thread's MR rows (or columns) in a tile, for index t of
// its 16 x 16 grid
template <int TILE>
__device__ __forceinline__ int tile_row(int t, int i) {
    if (TILE == 128) return 4 * t + (i & 3) + 64 * (i >> 2);
    return (TILE / 16) * t + i;
}

// a thread's MR panel entries at one column of the slice
template <int TILE>
__device__ __forceinline__ void load_frag(const float* row, int t,
                                          float* out) {
    if (TILE == 128) {
        const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
        const float4 b = *reinterpret_cast<const float4*>(row + 4 * t + 64);
        out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
        out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
    } else {
        const float2 a = *reinterpret_cast<const float2*>(row + 2 * t);
        out[0] = a.x; out[1] = a.y;
    }
}

// the inverse of load_frag: a thread's MR entries of one tile row
template <int TILE>
__device__ __forceinline__ void store_frag(float* row, int t,
                                           const float* x) {
    if (TILE == 128) {
        *reinterpret_cast<float4*>(row + 4 * t) =
            make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(row + 4 * t + 64) =
            make_float4(x[4], x[5], x[6], x[7]);
    } else {
        *reinterpret_cast<float2*>(row + 2 * t) = make_float2(x[0], x[1]);
    }
}

// upper-triangle tile t of nt x nt -> (ti, tj), ti <= tj, row by row;
// ops.py:gram_tile walks the same order for the plan's tests, so a change
// here is made there too
__device__ __forceinline__ void tile_of(int t, int nt, int& ti, int& tj) {
    ti = 0;
    while (t >= nt - ti) {
        t -= nt - ti;
        ++ti;
    }
    tj = ti + t;
}

// K[r, c] and K[c, r] of one partition, where r <= c
__device__ __forceinline__ void store_pair(float* kp, int n, int r, int c,
                                           float x) {
    kp[(size_t)r * n + c] = x;
    kp[(size_t)c * n + r] = x;
}

template <int TILE>
__global__ void __launch_bounds__(THREADS, 2)
omp_gram_kernel(const float* __restrict__ g, float* __restrict__ out,
                float* __restrict__ part, int P, int n, int D, int slice) {
    constexpr int MR = TILE / 16;
    constexpr int LD = TILE + 4;            // panel row pitch (floats)
    extern __shared__ __align__(16) float smem[];
    float* As = smem;                       // [STAGES][BK][LD] rows i0 ..
    float* Bs = smem + STAGES * BK * LD;    // [STAGES][BK][LD] rows j0 ..

    const int nt = (n + TILE - 1) / TILE;
    int ti, tj;
    tile_of(blockIdx.x, nt, ti, tj);
    const bool diag = ti == tj;
    const int split = blockIdx.y;
    const int p = blockIdx.z;
    const int i0 = ti * TILE;
    const int j0 = tj * TILE;
    const int k_lo = split * slice;
    const int k_hi = min(D, k_lo + slice);
    const float* gp = g + (size_t)p * n * D;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    // one BK-column slice of the row panel(s) into stage st, transposed:
    // thread tid copies column kb + tid % BK of rows tid / BK + 8 l
    constexpr int ROWS_A_PASS = THREADS / BK;
    const int kk_ld = tid % BK;
    const int r_ld = tid / BK;
    auto load = [&](int kb, int st) {
        const bool in_k = kb + kk_ld < k_hi;
        float* a_dst = As + (st * BK + kk_ld) * LD + r_ld;
        float* b_dst = Bs + (st * BK + kk_ld) * LD + r_ld;
        const float* a_src = gp + (size_t)(i0 + r_ld) * D + kb + kk_ld;
        const float* b_src = gp + (size_t)(j0 + r_ld) * D + kb + kk_ld;
        // not unrolled: the 2 x 16 source addresses would otherwise be
        // hoisted out of the D loop into registers the products need
#pragma unroll 1
        for (int r = r_ld; r < TILE; r += ROWS_A_PASS) {
            cp_async4(a_dst, in_k && i0 + r < n ? a_src : gp,
                      in_k && i0 + r < n);
            if (!diag)
                cp_async4(b_dst, in_k && j0 + r < n ? b_src : gp,
                          in_k && j0 + r < n);
            a_dst += ROWS_A_PASS;
            b_dst += ROWS_A_PASS;
            a_src += (size_t)ROWS_A_PASS * D;
            b_src += (size_t)ROWS_A_PASS * D;
        }
    };

    float acc[MR][MR];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) acc[i][j] = 0.0f;

    const int n_steps = (k_hi - k_lo + BK - 1) / BK;
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < n_steps) load(k_lo + st * BK, st);
        cp_async_commit();
    }
    for (int it = 0; it < n_steps; ++it) {
        cp_async_wait<STAGES - 2>();        // step it is in (this thread's)
        __syncthreads();                    // ... everyone's; it - 1 is read
        if (it + STAGES - 1 < n_steps)
            load(k_lo + (it + STAGES - 1) * BK, (it + STAGES - 1) % STAGES);
        cp_async_commit();
        const int st = it % STAGES;
        const float* Ap = As + st * BK * LD;
        const float* Bp = (diag ? As : Bs) + st * BK * LD;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[MR], b[MR];
            load_frag<TILE>(Ap + kk * LD, ty, a);
            load_frag<TILE>(Bp + kk * LD, tx, b);
#pragma unroll
            for (int i = 0; i < MR; ++i)
#pragma unroll
                for (int j = 0; j < MR; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }

    if (gridDim.y == 1) {
        float* kp = out + (size_t)p * n * n;
#pragma unroll
        for (int i = 0; i < MR; ++i) {
            const int r = i0 + tile_row<TILE>(ty, i);
#pragma unroll
            for (int j = 0; j < MR; ++j) {
                const int c = j0 + tile_row<TILE>(tx, j);
                if (r < n && c < n && r <= c) store_pair(kp, n, r, c,
                                                         acc[i][j]);
            }
        }
        return;
    }
    // partial tile of this split: part[split][p][t][TILE][TILE]
    float* pt = part + (((size_t)split * P + p) * gridDim.x + blockIdx.x)
                       * TILE * TILE;
#pragma unroll
    for (int i = 0; i < MR; ++i)
        store_frag<TILE>(pt + tile_row<TILE>(ty, i) * TILE, tx, acc[i]);
}

// K from the partial tiles, summed in split order: one block a 32 x 32
// block of a tile and a partition; the sums go through shared memory so
// that both K[r, c] and the mirror K[c, r] are written a row at a time
constexpr int SB = 32;

template <int TILE>
__global__ void __launch_bounds__(THREADS)
omp_gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                       int P, int n, int n_tiles, int splits) {
    constexpr int NSB = TILE / SB;
    __shared__ float sums[SB][SB + 1];
    const int t = blockIdx.x / (NSB * NSB);
    const int sa = blockIdx.x % (NSB * NSB) / NSB;
    const int sb = blockIdx.x % NSB;
    const int p = blockIdx.y;
    const size_t per_split = (size_t)P * n_tiles * TILE * TILE;
    const float* src = part + ((size_t)p * n_tiles + t) * TILE * TILE
                       + sa * SB * TILE + sb * SB;
    for (int e = threadIdx.x; e < SB * SB; e += THREADS) {
        const int a = e / SB, b = e % SB;
        float s = src[a * TILE + b];
        for (int sp = 1; sp < splits; ++sp)
            s += src[sp * per_split + a * TILE + b];
        sums[a][b] = s;
    }
    __syncthreads();
    int ti, tj;
    tile_of(t, (n + TILE - 1) / TILE, ti, tj);
    const int r0 = ti * TILE + sa * SB;
    const int c0 = tj * TILE + sb * SB;
    float* kp = out + (size_t)p * n * n;
    for (int e = threadIdx.x; e < SB * SB; e += THREADS) {
        const int a = e / SB, b = e % SB;
        int r = r0 + a, c = c0 + b;                 // K[r, c], by rows
        if (r < n && c < n && r <= c) kp[(size_t)r * n + c] = sums[a][b];
        r = r0 + b;                                 // K[c, r], by rows of c
        c = c0 + a;
        if (r < n && c < n && r <= c) kp[(size_t)c * n + r] = sums[b][a];
    }
}

template <int TILE>
int launch(const float* g, float* out, float* part, int P, int n, int D,
           int splits, int slice, cudaStream_t stream) {
    const int nt = (n + TILE - 1) / TILE;
    const int n_tiles = nt * (nt + 1) / 2;
    if (splits > 65535 || P > 65535) return (int)cudaErrorInvalidValue;
    const int smem = 2 * STAGES * BK * (TILE + 4) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        omp_gram_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    omp_gram_kernel<TILE><<<dim3(n_tiles, splits, P), THREADS, smem,
                            stream>>>(g, out, part, P, n, D, slice);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    constexpr int NSB = TILE / SB;
    omp_gram_reduce_kernel<TILE><<<dim3(n_tiles * NSB * NSB, P), THREADS, 0,
                                   stream>>>(part, out, P, n, n_tiles,
                                             splits);
    return (int)cudaGetLastError();
}

}  // namespace

// tile 32 or 128; splits D slices of `slice` columns (a multiple of
// BK); part holds splits x P x tiles x tile^2 floats when splits > 1 and
// may be null otherwise.
extern "C" int omp_gram_batched_launch(const float* g, float* out,
                                       float* part, int P, int n, int D,
                                       int tile, int splits, int slice,
                                       void* stream) {
    if (P <= 0 || n <= 0 || D <= 0 || splits <= 0 || slice <= 0
        || slice % BK != 0 || (long long)(splits - 1) * slice >= D
        || (long long)splits * slice < D || (splits > 1 && part == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 32: return launch<32>(g, out, part, P, n, D, splits, slice, st);
        case 128: return launch<128>(g, out, part, P, n, D, splits, slice, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
