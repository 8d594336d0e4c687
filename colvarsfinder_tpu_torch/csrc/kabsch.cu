// Batched Kabsch rotation kernels for Hopper (sm_90a), plain C interface
// loaded with ctypes by colvarsfinder_tpu_torch/ops/_cuda.py.
//
// cvf_kabsch_qcp (K1) replaces _kabsch_kernel in
// colvarsfinder_tpu/ops/kabsch_pallas.py:48 (launched at :86): covariances
// C [B,3,3] -> rotations R [B,3,3]. The JAX host code normalizes C by
// ||C||_F and substitutes the identity covariance for ||C||_F <= 1e-12;
// here both happen in the kernel, and a degenerate frame gets R = I
// directly (what the QCP of the identity covariance converges to).
//
// cvf_fused_align (K2) replaces the kernel of _make_fused_align_kernel
// (kabsch_pallas.py:140-206, launched at :223): centroid of the align atoms,
// covariance against the centered reference, Frobenius normalization with
// the fro2 > 1e-24 guard, QCP, and rotation of all N atoms about the
// centroid. The Pallas kernel bakes the reference into the compiled kernel;
// here the reference [m,3] and the align indices [m] are kernel arguments,
// so one build serves every layer.
//
// What bounds them on the H100: both move little data (K1 72 B/frame,
// K2 240 B/frame at N = 10) and do a few hundred flops per frame, so at
// B = 20,000 both sit near the launch latency. Design: one thread per
// frame, all QCP state in registers, no shared memory and no
// synchronization. K2 reads a frame's 30 floats with a stride of 120 B
// between neighbouring threads; staging frames through shared memory for
// coalesced loads is left for a later change.

#include <cuda_runtime.h>

#include "qcp.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void kabsch_qcp_kernel(const float* __restrict__ C,
                                  float* __restrict__ R, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float* cb = C + (size_t)b * 9;
    float c[9];
    float fro2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        c[i] = cb[i];
        fro2 += c[i] * c[i];
    }
    const float norm = sqrtf(fro2);
    float r[9];
    if (norm > 1e-12f) {
#pragma unroll
        for (int i = 0; i < 9; ++i) c[i] = c[i] / norm;
        cvf::qcp_rotation(c, r);
    } else {
        cvf::identity9(r);
    }
    float* rb = R + (size_t)b * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) rb[i] = r[i];
}

__global__ void fused_align_kernel(const float* __restrict__ x,
                                   const float* __restrict__ ref,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int B, int N,
                                   int m) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float* xb = x + (size_t)b * N * 3;
    const float inv_m = 1.0f / (float)m;

    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    for (int a = 0; a < m; ++a) {
        const int n = __ldg(idx + a);
        cx += xb[3 * n + 0] * inv_m;
        cy += xb[3 * n + 1] * inv_m;
        cz += xb[3 * n + 2] * inv_m;
    }

    float c[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int a = 0; a < m; ++a) {
        const int n = __ldg(idx + a);
        const float xc[3] = {xb[3 * n + 0] - cx, xb[3 * n + 1] - cy,
                             xb[3 * n + 2] - cz};
        const float rf[3] = {__ldg(ref + 3 * a + 0), __ldg(ref + 3 * a + 1),
                             __ldg(ref + 3 * a + 2)};
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) c[3 * i + j] += xc[i] * rf[j];
    }

    float fro2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) fro2 += c[i] * c[i];
    float R[9];
    if (fro2 > 1e-24f) {
        const float inv_norm = rsqrtf(fro2 + 1e-30f);
#pragma unroll
        for (int i = 0; i < 9; ++i) c[i] *= inv_norm;
        cvf::qcp_rotation(c, R);
    } else {
        cvf::identity9(R);
    }

    float* ob = out + (size_t)b * N * 3;
    for (int n = 0; n < N; ++n) {
        const float x0 = xb[3 * n + 0] - cx;
        const float x1 = xb[3 * n + 1] - cy;
        const float x2 = xb[3 * n + 2] - cz;
#pragma unroll
        for (int j = 0; j < 3; ++j)
            ob[3 * n + j] = x0 * R[j] + x1 * R[3 + j] + x2 * R[6 + j];
    }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success) without synchronizing.

int cvf_kabsch_qcp(const float* C, float* R, int B, void* stream) {
    if (B <= 0) return 0;
    const int grid = (B + kThreads - 1) / kThreads;
    kabsch_qcp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(C, R, B);
    return (int)cudaGetLastError();
}

int cvf_fused_align(const float* x, const float* ref, const int* idx,
                    float* out, int B, int N, int m, void* stream) {
    if (B <= 0) return 0;
    const int grid = (B + kThreads - 1) / kThreads;
    fused_align_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, ref, idx, out, B, N, m);
    return (int)cudaGetLastError();
}

}  // extern "C"
