// Grouped pair distances for Hopper (sm_90a), plain C interface loaded
// with ctypes by colvarsfinder_tpu_torch/ops/_cuda.py.
//
// cvf_pair_distances (K5): frames x [B,N,3] float32 or float64 and a pair
// list [P,2] int32 in, distances out[b,p] = |x[b,j_p] - x[b,i_p]| [B,P]
// in x's dtype out. It is the forward of a FeatureLayer's run of
// consecutive 'bond' features (ops/features.py pair_distances, its plain
// version). The JAX package has no counterpart: there every feature is
// its own small XLA computation, which XLA fuses.
//
// What bounds it on the H100: each frame's distances are written once,
// P values against 3N values read (at N = 93 and P = 4,278, 15 bytes
// written per byte read), so the kernel's floor is its writes at the
// card's memory rate. One block takes one frame: it copies the frame's 3N
// values into shared memory in order, coalesced, then its threads take
// pairs p = tid, tid + 256, ..., each reading the pair's two indices and
// six coordinates and writing one distance; the warp's 32 threads write
// 32 consecutive distances, one 128-byte line in float32. The pair list
// (8 bytes a pair, one load) is read by every block from L1 and L2; read
// as int64 (16 bytes a pair) it took 189 us in place of 150. On an H100 at
// the CLN025 shapes, tiles of 2 to 32 frames a block, with the pair loop
// outside or inside the frame loop, took 1.1 to 3 times as long, and
// stores with the streaming hint (__stcs) the same time. Every distance
// is computed in x's precision: d = r_j - r_i, then
// sqrt((dx*dx + dy*dy) + dz*dz) in that order, with no contraction to FMA
// (the _rn intrinsics) and the IEEE square root.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// shared memory a block takes without opting in to more
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

template <typename T> struct Rn;

template <> struct Rn<float> {
    static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
    static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
    static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
    static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <> struct Rn<double> {
    static __device__ double sub(double a, double b) {
        return __dsub_rn(a, b);
    }
    static __device__ double add(double a, double b) {
        return __dadd_rn(a, b);
    }
    static __device__ double mul(double a, double b) {
        return __dmul_rn(a, b);
    }
    static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// Shared memory: the block's frame, [3 N].
template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_distances_kernel(const T* __restrict__ x,
                      const int2* __restrict__ pairs,
                      T* __restrict__ out, int N, int P) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* sx = reinterpret_cast<T*>(smem);
    const int W = 3 * N;
    const T* src = x + (size_t)blockIdx.x * W;
    for (int e = threadIdx.x; e < W; e += kThreads) sx[e] = src[e];
    __syncthreads();

    T* dst = out + (size_t)blockIdx.x * P;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        const int2 ij = __ldg(pairs + p);
        const T* a = sx + 3 * ij.x;
        const T* b = sx + 3 * ij.y;
        const T dx = Rn<T>::sub(b[0], a[0]);
        const T dy = Rn<T>::sub(b[1], a[1]);
        const T dz = Rn<T>::sub(b[2], a[2]);
        const T s = Rn<T>::add(
            Rn<T>::add(Rn<T>::mul(dx, dx), Rn<T>::mul(dy, dy)),
            Rn<T>::mul(dz, dz));
        dst[p] = Rn<T>::sqrt(s);
    }
}

// The shared memory a block may take on the current device, opted in.
int max_smem(size_t* bytes) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    *bytes = (size_t)optin;
    return (int)err;
}

// Opts the kernel in to `smem` bytes of dynamic shared memory where that
// is past the default; once per device and precision.
template <typename T>
int opt_in(size_t smem) {
    static size_t done[kMaxDevices] = {};
    if (smem <= kDefaultSmem) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices && done[dev] >= smem) return 0;
    err = cudaFuncSetAttribute(pair_distances_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess && dev < kMaxDevices) done[dev] = smem;
    return (int)err;
}

template <typename T>
int launch(const T* x, const int2* pairs, T* out, int B, int N, int P,
           cudaStream_t stream) {
    const size_t smem = (size_t)3 * N * sizeof(T);
    size_t most = 0;
    int err = max_smem(&most);
    if (err) return err;
    if (smem > most) return (int)cudaErrorInvalidValue;
    err = opt_in<T>(smem);
    if (err) return err;
    pair_distances_kernel<T><<<B, kThreads, smem, stream>>>(x, pairs, out,
                                                            N, P);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success)
// without synchronizing: one block of 256 threads per frame with 3 N
// values of dynamic shared memory, past 48 KiB opted in up to the
// device's limit (227 KiB on an H100: N up to 19,370 in float32, 9,685
// in float64; cvf_pair_distances_max_atoms). `x` and `out` are float64
// where `f64` is nonzero, else float32. `pairs` holds P rows (i, j), each
// index in [0, N).
int cvf_pair_distances(const void* x, const void* pairs, void* out, int B,
                       int N, int P, int f64, void* stream) {
    if (B <= 0 || P <= 0) return 0;
    if (N < 1) return (int)cudaErrorInvalidValue;
    const int2* pl = static_cast<const int2*>(pairs);
    cudaStream_t s = (cudaStream_t)stream;
    if (f64)
        return launch(static_cast<const double*>(x), pl,
                      static_cast<double*>(out), B, N, P, s);
    return launch(static_cast<const float*>(x), pl,
                  static_cast<float*>(out), B, N, P, s);
}

// The most atoms a frame may have for a launch on the current device
// (float64 where `f64` is nonzero), written to `out`.
int cvf_pair_distances_max_atoms(int f64, int* out) {
    size_t most = 0;
    const int err = max_smem(&most);
    *out = (int)(most / (3 * (f64 ? sizeof(double) : sizeof(float))));
    return err;
}

}  // extern "C"
