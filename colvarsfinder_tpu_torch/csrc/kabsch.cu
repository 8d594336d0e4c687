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
// B = 20,000 both sit near the launch latency plus one dependent QCP chain
// per frame. So both spread small blocks over every SM and move their bytes
// in coalesced runs. The QCP chain keeps all 16 Newton steps: an early exit
// at the loop's fixed point changes how nvcc fuses multiply-adds around the
// loop, and with them the bits (scripts/k4_ablation.py k1).
//
// K1 (kabsch_qcp_kernel): one block of T threads per tile of T
// consecutive frames. The tile's T * 9 floats are contiguous in C, so the
// block copies them into shared memory with coalesced 4-byte cp.async
// copies, all in flight at once, whatever the tile's alignment. One thread
// per frame reads its 9 entries at a stride of 9 words (odd: no bank
// conflicts), normalizes them (one reciprocal, nine multiplies), solves QCP
// and leaves R in its own 9 slots; the block then stores the tile's T * 9
// outputs in order, coalesced.
//
// K2 has two variants; the caller picks one by the frame's size
// (align_launch_shape in ops/kabsch_cuda.py):
// - staged (fused_align_staged_kernel): one block per tile of T
//   consecutive frames. The tile is contiguous in x, so the block copies it
//   into shared memory with coalesced 4-byte cp.async copies, all in flight
//   at once, whatever the tile's alignment; the reference and the indices
//   come along. A frame's stride in shared memory is padded to an odd word
//   count, so one thread per frame reads it without bank conflicts. One
//   thread per frame then forms centroid and covariance in the order of the
//   direct variant, solves QCP and leaves R and the centroid in shared
//   memory; all threads then rotate the tile together, one output float
//   each, stored in order: coalesced, and nothing staged on the way out.
// - direct (fused_align_direct_kernel): one thread per frame reading its
//   frame from device memory, for frames too large for a shared-memory tile
//   (thousands of atoms).
// Both compute the same expressions in the same order.

#include <cuda_runtime.h>

#include "qcp.cuh"

namespace {

constexpr int kThreads = 256;        // K2's direct variant
constexpr int kStagedThreads = 128;  // K2's staged variant
constexpr int kMaxTile = 256;        // K1: frames (threads) per block
constexpr int kRStride = 13;         // R (9) and centroid (3), odd stride

// asynchronous 4-byte global -> shared copy (cp.async, sm_80+); all of a
// thread's copies are in flight together until cp_async_wait_all
__device__ __forceinline__ void cp_async_f32(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory: the tile's covariances, then its rotations, [T][9].
__global__ void __launch_bounds__(kMaxTile)
kabsch_qcp_kernel(const float* __restrict__ C, float* __restrict__ R,
                  int B) {
    extern __shared__ float sc[];
    const int tid = threadIdx.x;
    const int T = blockDim.x;
    const long b0 = (long)blockIdx.x * T;
    const int count = 9 * (int)min((long)T, (long)B - b0);
    const float* ct = C + b0 * 9;

    for (int e = tid; e < count; e += T) cp_async_f32(sc + e, ct + e);
    cp_async_wait_all();
    __syncthreads();

    if (9 * tid < count) {
        float* s = sc + 9 * tid;
        float c[9];
        float fro2 = 0.0f;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
            c[i] = s[i];
            fro2 += c[i] * c[i];
        }
        const float norm = sqrtf(fro2);
        float r[9];
        if (norm > 1e-12f) {
            const float inv = 1.0f / norm;
#pragma unroll
            for (int i = 0; i < 9; ++i) c[i] *= inv;
            cvf::qcp_rotation(c, r);
        } else {
            cvf::identity9(r);
        }
#pragma unroll
        for (int i = 0; i < 9; ++i) s[i] = r[i];
    }
    __syncthreads();

    float* rt = R + b0 * 9;
    for (int e = tid; e < count; e += T) rt[e] = sc[e];
}

// Centroid c of the align atoms and the rotation R of one frame xb (atom n
// at xb[3n..3n+2]); ref [m,3] and idx [m] may live in shared or device
// memory.
__device__ __forceinline__ void frame_rotation(const float* xb,
                                               const float* ref,
                                               const int* idx, int m,
                                               float c3[3], float R[9]) {
    const float inv_m = 1.0f / (float)m;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    for (int a = 0; a < m; ++a) {
        const int n = idx[a];
        cx += xb[3 * n + 0] * inv_m;
        cy += xb[3 * n + 1] * inv_m;
        cz += xb[3 * n + 2] * inv_m;
    }
    float c[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int a = 0; a < m; ++a) {
        const int n = idx[a];
        const float xc[3] = {xb[3 * n + 0] - cx, xb[3 * n + 1] - cy,
                             xb[3 * n + 2] - cz};
        const float rf[3] = {ref[3 * a + 0], ref[3 * a + 1], ref[3 * a + 2]};
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) c[3 * i + j] += xc[i] * rf[j];
    }
    float fro2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) fro2 += c[i] * c[i];
    if (fro2 > 1e-24f) {
        const float inv_norm = rsqrtf(fro2 + 1e-30f);
#pragma unroll
        for (int i = 0; i < 9; ++i) c[i] *= inv_norm;
        cvf::qcp_rotation(c, R);
    } else {
        cvf::identity9(R);
    }
    c3[0] = cx;
    c3[1] = cy;
    c3[2] = cz;
}

// one output coordinate: component j of (x - c) R for the atom at xa
__device__ __forceinline__ float rotated(const float* xa, const float* c3,
                                         const float* R, int j) {
    const float x0 = xa[0] - c3[0];
    const float x1 = xa[1] - c3[1];
    const float x2 = xa[2] - c3[2];
    return x0 * R[j] + x1 * R[3 + j] + x2 * R[6 + j];
}

__global__ void __launch_bounds__(kThreads)
fused_align_direct_kernel(const float* __restrict__ x,
                          const float* __restrict__ ref,
                          const int* __restrict__ idx,
                          float* __restrict__ out, int B, int N, int m) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float* xb = x + (size_t)b * N * 3;
    float c3[3], R[9];
    frame_rotation(xb, ref, idx, m, c3, R);
    float* ob = out + (size_t)b * N * 3;
    for (int n = 0; n < N; ++n)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            ob[3 * n + j] = rotated(xb + 3 * n, c3, R, j);
}

// Shared memory (floats): the tile sx [T][S] (S = 3N rounded up to odd),
// sR [T][kRStride], the reference [m][3], the indices [m] (int).
__global__ void __launch_bounds__(kStagedThreads)
fused_align_staged_kernel(const float* __restrict__ x,
                          const float* __restrict__ ref,
                          const int* __restrict__ idx,
                          float* __restrict__ out, int B, int N, int m,
                          int T) {
    extern __shared__ float smem[];
    const int W = 3 * N;  // floats per frame
    const int S = W | 1;
    float* sx = smem;
    float* sR = sx + T * S;
    float* sref = sR + T * kRStride;
    int* sidx = reinterpret_cast<int*>(sref + 3 * m);
    const int tid = threadIdx.x;
    const long b0 = (long)blockIdx.x * T;
    const int nf = min((long)T, (long)B - b0);
    const int count = nf * W;
    const float* xt = x + b0 * W;

    for (int e = tid; e < count; e += kStagedThreads) {
        const int f = e / W;
        cp_async_f32(sx + f * S + (e - f * W), xt + e);
    }
    for (int e = tid; e < 3 * m; e += kStagedThreads)
        cp_async_f32(sref + e, ref + e);
    for (int e = tid; e < m; e += kStagedThreads)
        cp_async_f32(sidx + e, idx + e);
    cp_async_wait_all();
    __syncthreads();

    if (tid < nf) {
        float c3[3], Rf[9];
        frame_rotation(sx + tid * S, sref, sidx, m, c3, Rf);
        float* r = sR + tid * kRStride;
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = Rf[i];
        r[9] = c3[0];
        r[10] = c3[1];
        r[11] = c3[2];
    }
    __syncthreads();

    float* ot = out + b0 * W;
    for (int e = tid; e < count; e += kStagedThreads) {
        const int f = e / W;
        const int r = e - f * W;
        const int n = r / 3;
        const float* rr = sR + f * kRStride;
        ot[e] = rotated(sx + f * S + 3 * n, rr + 9, rr, r - 3 * n);
    }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success) without synchronizing.

// K1 with one block of `tile` threads (1..256) per `tile` frames.
int cvf_kabsch_qcp(const float* C, float* R, int B, int tile, void* stream) {
    if (B <= 0) return 0;
    if (tile < 1 || tile > kMaxTile) return (int)cudaErrorInvalidValue;
    const int grid = (B + tile - 1) / tile;
    kabsch_qcp_kernel<<<grid, tile, tile * 9 * sizeof(float),
                        (cudaStream_t)stream>>>(C, R, B);
    return (int)cudaGetLastError();
}

// K1 blocks of `tile` frames resident on one SM of the current card.
int cvf_kabsch_qcp_occupancy(int tile, int* blocks_per_sm) {
    if (tile < 1 || tile > kMaxTile) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kabsch_qcp_kernel, tile, tile * 9 * sizeof(float));
}

// tile 0: the direct variant; tile 1..128: the staged variant with one
// block of 128 threads per `tile` frames and `smem_bytes` of dynamic shared
// memory (align_smem_bytes in ops/kabsch_cuda.py).
int cvf_fused_align(const float* x, const float* ref, const int* idx,
                    float* out, int B, int N, int m, int tile,
                    int smem_bytes, void* stream) {
    if (B <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    if (tile == 0) {
        const int grid = (B + kThreads - 1) / kThreads;
        fused_align_direct_kernel<<<grid, kThreads, 0, st>>>(x, ref, idx,
                                                             out, B, N, m);
        return (int)cudaGetLastError();
    }
    if (tile < 0 || tile > kStagedThreads) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fused_align_staged_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const int grid = (B + tile - 1) / tile;
    fused_align_staged_kernel<<<grid, kStagedThreads, smem_bytes, st>>>(
        x, ref, idx, out, B, N, m, tile);
    return (int)cudaGetLastError();
}

// Blocks of the staged variant resident on one SM of the current card at a
// launch shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int cvf_fused_align_occupancy(int smem_bytes, int* blocks_per_sm) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_align_staged_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_align_staged_kernel, kStagedThreads,
        smem_bytes);
}

}  // extern "C"
