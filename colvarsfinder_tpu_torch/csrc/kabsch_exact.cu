// K6: the rotation solve of AlignmentLayer(method='quaternion') on the card,
// bit for bit the plain chain it replaces, plain C interface loaded with
// ctypes by colvarsfinder_tpu_torch/ops/_cuda.py.
//
// cvf_kabsch_exact: covariances C [B,3,3] float32 -> rotations R [B,3,3],
// equal to every bit to kabsch_rotations_quat (ops/alignment.py) run by
// PyTorch's own kernels on the card. It has no TPU counterpart: there XLA
// fuses that chain, while eager PyTorch runs each of its ~760 operations as
// a kernel of its own over [B].
//
// Exactness. Each PyTorch kernel of the chain rounds one IEEE float32
// operation at a time, so this file is built with -fmad=false (no product
// is contracted into an FMA; _cuda.py gives this library that flag alone)
// and repeats the chain step by step in its order: the squares of C, their
// sum, the root, `ok = norm > 1e-12`, the nine IEEE divisions by the norm,
// qcp_rotation (qcp.cuh: the quartic's coefficients, 16 Newton steps plus
// the chain's extra differentiable ones, the largest cofactor row, rsqrtf,
// the rotation entries), and the identity where !ok. sqrtf and IEEE
// division are what PyTorch's sqrt and div call, rsqrtf what its rsqrt
// calls. The chain sums ||C||^2 elementwise, left to right over the
// row-major entries, and so does this kernel: no reduction kernel's order
// enters either.
//
// Bound: 36 B read and 36 B written per frame (1.44 MB at B = 20,000: 0.43
// us at 3.35 TB/s); ~640 dependent float32 operations per frame, so at
// B = 20,000 the launch and one QCP chain per thread set the time, as in K1.
//
// Design (K1's): one block of kTile threads per tile of kTile consecutive
// frames. The tile's kTile * 9 floats are contiguous in C; the block loads
// them into shared memory in coalesced runs, one thread per frame then
// reads its 9 entries at a stride of 9 words (odd: no bank conflicts),
// solves and leaves R in its own slots, and the block stores the tile's
// outputs in order, coalesced.

#include <cuda_runtime.h>

#include "qcp.cuh"

namespace {

constexpr int kTile = 32;  // frames (threads) per block

__global__ void __launch_bounds__(kTile)
kabsch_exact_kernel(const float* __restrict__ C, float* __restrict__ R,
                    int B, int iters) {
    __shared__ float sc[kTile * 9];
    const int tid = threadIdx.x;
    const long b0 = (long)blockIdx.x * kTile;
    const int count = 9 * (int)min((long)kTile, (long)B - b0);
    const float* ct = C + b0 * 9;

#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const int e = tid + k * kTile;
        if (e < count) sc[e] = ct[e];
    }
    __syncthreads();

    if (9 * tid < count) {
        float* s = sc + 9 * tid;
        float c[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) c[i] = s[i];
        float fro2 = c[0] * c[0];
#pragma unroll
        for (int i = 1; i < 9; ++i) fro2 = fro2 + c[i] * c[i];
        const float norm = sqrtf(fro2);
        float r[9];
        if (norm > 1e-12f) {
#pragma unroll
            for (int i = 0; i < 9; ++i) c[i] = c[i] / norm;
            cvf::qcp_rotation(c, r, iters);
        } else {
            cvf::identity9(r);
        }
#pragma unroll
        for (int i = 0; i < 9; ++i) s[i] = r[i];
    }
    __syncthreads();

    float* rt = R + b0 * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const int e = tid + k * kTile;
        if (e < count) rt[e] = sc[e];
    }
}

}  // namespace

extern "C" {

// iters: Newton steps per frame (16 + the plain chain's extra steps).
int cvf_kabsch_exact(const float* C, float* R, int B, int iters,
                     void* stream) {
    if (B <= 0) return 0;
    if (iters < 0) return (int)cudaErrorInvalidValue;
    const int grid = (B + kTile - 1) / kTile;
    kabsch_exact_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(C, R, B,
                                                                   iters);
    return (int)cudaGetLastError();
}

}  // extern "C"
