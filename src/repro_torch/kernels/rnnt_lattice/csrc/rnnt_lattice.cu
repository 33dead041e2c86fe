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
// log-semiring combines, so the time is the latency of T x (loads +
// log2(32) shuffle rounds) per row, far above the byte and FLOP bounds at
// the transducer's shapes (T' ~ 100s, U1 ~ 10s).
//
// Design: the TPU kernel walks a sequential grid over T and carries the
// row in VMEM; blocks on Hopper run in no order, so the T loop lives
// inside the block.  One warp (one block of 32 threads) owns one batch
// row.  Lane l owns the columns u = l, l+32, l+64, ...; its previous-row
// values live in shared memory at those columns only, so no lane reads
// what another lane wrote and the warp needs no barrier.  The in-row
// recurrence is an inclusive warp-shuffle (Hillis-Steele) scan over
// 32-wide pieces with the combine
//   (c1, b1) . (c2, b2) = (c1 + c2, logaddexp(b1 + c2, b2)),
// and the last value of each piece is carried into the next one, so any
// U1 works.  NEG stays -1e30 (never -inf: NEG + NEG must stay finite),
// and logaddexp is max + log1p(exp(-|a - b|)) in accurate fp32, as in
// jnp.logaddexp.
#include <cuda_runtime.h>

#define NEG (-1e30f)
#define WARP 32

__device__ __forceinline__ float log_add_exp(float a, float b) {
    const float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void __launch_bounds__(WARP)
rnnt_lattice_kernel(const float* __restrict__ mult,
                    const float* __restrict__ add,
                    const float* __restrict__ emit,
                    float* __restrict__ out, int T, int B, int U1) {
    extern __shared__ float prev[];              // (U1,) row t-1 of row b
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    for (int u = lane; u < U1; u += WARP) prev[u] = NEG;

    for (int t = 0; t < T; ++t) {
        const size_t row = ((size_t)t * B + b) * (size_t)U1;
        float carry = NEG;                       // a[u0 - 1]
        for (int u0 = 0; u0 < U1; u0 += WARP) {
            const int u = u0 + lane;
            const bool live = u < U1;
            // identity element (0, NEG) on the lanes past the row's end
            float bv = NEG;
            float c = 0.0f;
            if (live) {
                bv = log_add_exp(prev[u] + mult[row + u], add[row + u]);
                c = emit[row + u];
            }
#pragma unroll
            for (int d = 1; d < WARP; d <<= 1) {
                const float c_up = __shfl_up_sync(0xffffffffu, c, d);
                const float b_up = __shfl_up_sync(0xffffffffu, bv, d);
                if (lane >= d) {
                    bv = log_add_exp(b_up + c, bv);
                    c = c_up + c;
                }
            }
            if (u0 > 0) bv = log_add_exp(carry + c, bv);
            if (live) {
                out[row + u] = bv;
                prev[u] = bv;
            }
            carry = __shfl_sync(0xffffffffu, bv, WARP - 1);
        }
    }
}

extern "C" int rnnt_lattice_launch(const float* mult, const float* add,
                                   const float* emit, float* out,
                                   int T, int B, int U1, void* stream) {
    const size_t smem = (size_t)U1 * sizeof(float);
    rnnt_lattice_kernel<<<B, WARP, smem, (cudaStream_t)stream>>>(
        mult, add, emit, out, T, B, U1);
    return (int)cudaGetLastError();
}
