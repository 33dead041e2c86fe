// RNN-T lattice wavefront scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rnnt_lattice/kernel.py
// (rnnt_lattice, body _lattice_kernel).  It computes, per batch row b,
//   rows[t] = row_update(logaddexp(rows[t-1] + mult[t], add[t]), emit[t])
//   row_update: a[u] = logaddexp(base[u], a[u-1] + emit[u]), emit[.,.,0] = NEG
// with rows[-1] = NEG, on (T, B, U1) fp32 inputs.
//
// What bounds it on this card: neither bytes nor operations.  The T loop
// is a chain of dependent rows, and inside a row the scan is a chain of
// log-semiring combines, so the time is the latency of T rows, far above
// the byte and FLOP bounds at the transducer's shapes (T' ~ 100s, U1 ~
// 10s).  The design shortens the chain a row and takes device memory off
// it:
//
// - One warp (one block of 32 threads) owns one batch row.  A cp.async
//   ring keeps the next R rows (R = 16 for short rows, fewer for long
//   ones, at least 1 at U1 = 12,288) of mult, add and emit in shared
//   memory ahead of the scan, so the T loop reads only shared memory and
//   registers; row t + R - 1 is requested before row t is scanned.
// - Lane l owns q = ceil(U1 / 32) consecutive columns [l q, l q + q).  A
//   row is one sequential combine over the lane's q columns (from the
//   previous row's values of those columns, in shared memory, which only
//   that lane writes), one five-round shuffle scan of the lanes'
//   aggregates with the combine
//     (c1, b1) . (c2, b2) = (c1 + c2, logaddexp(b1 + c2, b2)),
//   and a fix-up of each column with the value carried in from the lane
//   before.  At U1 = 33 that is a chain of 8 combines a row, where the
//   first port's ceil(U1 / 32) full scans with a carry took 13 after
//   three loads from device memory.
// NEG stays -1e30 (never -inf: NEG + NEG must stay finite), and
// logaddexp is max + log1p(exp(-|a - b|)) in accurate fp32, as in
// jnp.logaddexp; no fast-math.  No atomics: two launches agree bit for
// bit.
//
// Tried and dropped: the first port (lane l owning columns l, l + 32,
// ..., each row ceil(U1 / 32) 32-wide shuffle scans with a carried
// prefix, after three loads from device memory that started only when
// the previous row was done): 0.2180 ms at (T', B, U1) = (128, 4, 33) on
// an H100 (NVIDIA H100 80GB HBM3, 700 W), ~1.7 us a row.
#include <cuda_runtime.h>

#define NEG (-1e30f)
#define WARP 32
#define FULL 0xffffffffu
#define SMEM_MAX 232448      // dynamic shared memory a block may take (H100)

__device__ __forceinline__ float log_add_exp(float a, float b) {
    const float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory: the previous row (U1, padded to 4) and R ring slots of
// (mult, add, emit) rows.
__host__ __device__ __forceinline__ size_t lattice_smem(int U1, int R) {
    return sizeof(float) * (((size_t)U1 + 3) / 4 * 4 + (size_t)R * 3 * U1);
}

template <int R>
__global__ void __launch_bounds__(WARP)
rnnt_lattice_kernel(const float* __restrict__ mult,
                    const float* __restrict__ add,
                    const float* __restrict__ emit,
                    float* __restrict__ out, int T, int B, int U1) {
    extern __shared__ float sm[];
    float* prev = sm;                            // row t-1 of row b  (U1)
    float* ring = sm + (U1 + 3) / 4 * 4;         // R x (mult, add, emit)
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int q = (U1 + WARP - 1) / WARP;
    const int u0 = min(lane * q, U1), u1 = min(u0 + q, U1);
    const int slot = 3 * U1;
    for (int u = u0; u < u1; ++u) prev[u] = NEG;

    // row t's three rows into ring slot t % R (coalesced: lane l copies
    // columns l, l + 32, ...); one commit group a row, empty past T
    auto request = [&](int t) {
        if (t < T) {
            float* dst = ring + (t % R) * slot;
            const size_t row = ((size_t)t * B + b) * (size_t)U1;
            for (int u = lane; u < U1; u += WARP) {
                cp_async4(dst + u, mult + row + u);
                cp_async4(dst + U1 + u, add + row + u);
                cp_async4(dst + 2 * U1 + u, emit + row + u);
            }
        }
        cp_async_commit();
    };
    for (int t = 0; t < R - 1; ++t) request(t);

    for (int t = 0; t < T; ++t) {
        request(t + R - 1);
        cp_async_wait<R - 1>();                  // row t has landed
        __syncwarp();
        const float* m = ring + (t % R) * slot;
        const float* a = m + U1;
        const float* e = a + U1;
        // 1. the lane's columns in order: prev[u] becomes the value the
        //    row would have at u if a[u0 - 1] were NEG; (cs, bs) is the
        //    lane's aggregate, (0, NEG) for a lane past the row's end
        float cs = 0.0f, bs = NEG;
        if (u0 < u1) {
            bs = log_add_exp(prev[u0] + m[u0], a[u0]);
            cs = e[u0];
            prev[u0] = bs;
            for (int u = u0 + 1; u < u1; ++u) {
                const float base = log_add_exp(prev[u] + m[u], a[u]);
                bs = log_add_exp(bs + e[u], base);
                cs += e[u];
                prev[u] = bs;
            }
        }
        // 2. inclusive shuffle scan of the aggregates; the carry into lane
        //    l is a[u0 - 1], the row's value at the last column before it
#pragma unroll
        for (int d = 1; d < WARP; d <<= 1) {
            const float c_up = __shfl_up_sync(FULL, cs, d);
            const float b_up = __shfl_up_sync(FULL, bs, d);
            if (lane >= d) {
                bs = log_add_exp(b_up + cs, bs);
                cs = c_up + cs;
            }
        }
        const float carry = __shfl_up_sync(FULL, bs, 1);
        // 3. fix-up: a[u] = logaddexp(carry + sum_{u0..u} e, local[u])
        const size_t row = ((size_t)t * B + b) * (size_t)U1;
        float c = 0.0f;
        for (int u = u0; u < u1; ++u) {
            float v = prev[u];
            if (lane > 0) {
                c += e[u];
                v = log_add_exp(carry + c, v);
                prev[u] = v;
            }
            out[row + u] = v;
        }
        __syncwarp();                            // slot t % R is free
    }
    cp_async_wait<0>();
}

template <int R>
static int launch(const float* mult, const float* add, const float* emit,
                  float* out, int T, int B, int U1, cudaStream_t st) {
    const size_t smem = lattice_smem(U1, R);
    cudaError_t err = cudaFuncSetAttribute(
        rnnt_lattice_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    rnnt_lattice_kernel<R><<<B, WARP, smem, st>>>(mult, add, emit, out, T,
                                                  B, U1);
    return (int)cudaGetLastError();
}

// The ring depth a row width takes: 16 rows where they fit, else the
// largest power of two that does (1 at U1 = 12,288); ops.py:ring_depth
// computes the same.
static int ring_depth(int U1) {
    for (int R = 16; R > 1; R >>= 1)
        if (lattice_smem(U1, R) <= SMEM_MAX) return R;
    return 1;
}

extern "C" int rnnt_lattice_launch(const float* mult, const float* add,
                                   const float* emit, float* out,
                                   int T, int B, int U1, void* stream) {
    if (U1 < 1 || lattice_smem(U1, 1) > SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (ring_depth(U1)) {
        case 16: return launch<16>(mult, add, emit, out, T, B, U1, st);
        case 8: return launch<8>(mult, add, emit, out, T, B, U1, st);
        case 4: return launch<4>(mult, add, emit, out, T, B, U1, st);
        case 2: return launch<2>(mult, add, emit, out, T, B, U1, st);
        default: return launch<1>(mult, add, emit, out, T, B, U1, st);
    }
}
