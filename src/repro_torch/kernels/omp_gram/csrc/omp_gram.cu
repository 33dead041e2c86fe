// Batched Gram matrix K_p = G_p G_p^T for Hopper (sm_90a), fp32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/omp_gram/kernel.py
// (omp_gram_batched, body _gram_kernel; omp_gram is its P = 1 case): the
// stage-B Gram of every partition, accumulated in fp32 over D tiles with
// the ragged n and D edges zero-padded.
//
// What bounds it on this card: operations at large n (2 P n^2 D FLOPs
// against P n D inputs: n / 2 FLOPs per byte read, so above the fp32
// ridge of ~20 FLOP/byte once n is in the hundreds), bytes at the tiny
// per-partition n of the smoke path.  TF32 and the tensor cores are off
// by contract: the reference computes this Gram in full fp32.
//
// Design: a plain tiled SIMT GEMM, one 64 x 64 output tile per block and
// blockIdx.z = partition.  Each K-slice of 16 columns of both row panels
// is staged through shared memory (stored transposed, one float of
// padding per row against bank conflicts), and each of the 256 threads
// keeps a 4 x 4 block of fp32 accumulators in registers, updated with
// fmaf in D order.  Loads and stores outside n or D are masked (zero in,
// nothing out).  wgmma/TMA and upper-triangle-only tiling are later work.
#include <cuda_runtime.h>

#define BM 64
#define BK 16
#define THREADS 256

__global__ void __launch_bounds__(THREADS)
omp_gram_kernel(const float* __restrict__ g, float* __restrict__ out,
                int n, int D) {
    __shared__ float As[BK][BM + 1];
    __shared__ float Bs[BK][BM + 1];
    const int p = blockIdx.z;
    const int i0 = blockIdx.y * BM;
    const int j0 = blockIdx.x * BM;
    const float* gp = g + (size_t)p * n * D;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
        for (int l = 0; l < (BM * BK) / THREADS; ++l) {
            const int e = tid + l * THREADS;     // 16 lanes per row of G
            const int r = e / BK;
            const int kk = e % BK;
            const int k = k0 + kk;
            const int ri = i0 + r;
            const int rj = j0 + r;
            As[kk][r] = (ri < n && k < D) ? gp[(size_t)ri * D + k] : 0.0f;
            Bs[kk][r] = (rj < n && k < D) ? gp[(size_t)rj * D + k] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], bb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* op = out + (size_t)p * n * n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty * 4 + i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = j0 + tx * 4 + j;
            if (c < n) op[(size_t)r * n + c] = acc[i][j];
        }
    }
}

extern "C" int omp_gram_batched_launch(const float* g, float* out, int P,
                                       int n, int D, void* stream) {
    const dim3 grid((n + BM - 1) / BM, (n + BM - 1) / BM, P);
    omp_gram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(g, out, n, D);
    return (int)cudaGetLastError();
}
