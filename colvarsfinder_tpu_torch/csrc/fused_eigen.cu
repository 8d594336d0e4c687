// Fused transfer-operator statistics kernels for Hopper (sm_90a), plain C
// interface loaded with ctypes by colvarsfinder_tpu_torch/ops/_cuda.py.
//
// cvf_stats_fwd (K3) replaces _fwd_kernel_factory in
// colvarsfinder_tpu/ops/fused_eigen.py:146-215 (launched at :437): the k-head
// tanh MLP on F and F_l [B, d] reduced to the stats vector
//   tw, twl, s1[k], s2[k], s1l[k], s2l[k], sd[k], sc[k(k-1)/2]
// in stats_layout order (fused_eigen.py:72-81).
// cvf_stats_bwd (K4) replaces _bwd_kernel_factory (:230-321, launched at
// :486): from dL/dstats it recomputes the activations, forms the per-sample
// output cotangents (:290-299), backpropagates through each head and
// accumulates dW, db. The data inputs get no gradient.
//
// Layouts. params (and grads) are one flat float32 buffer; for each layer l
// it holds W_t[l] [k, d_l, d_{l+1}] then b[l] [k, d_{l+1}] (the transposed
// weight layout of params_t_of). The last layer has d_L = 1.
//
// Design. A block of T threads (T = 32, 64 or 128, chosen by the caller so
// that the shared memory below fits) owns one tile of T consecutive
// samples, one thread per sample. All heads' weights sit in shared memory;
// per-sample activations live in shared memory as rows [width][T + 1] (the
// +1 pads away bank conflicts when threads read different rows). The tail
// tile is masked: its missing samples read zeros and carry zero weight, so
// they add nothing to any statistic or gradient; the caller's tensors are
// never padded.
//
// Determinism. TPU grids run in order and the Pallas kernels accumulate
// every tile into one output block. CUDA blocks run in no order, so each
// block writes its own partial vector and a second launch reduces the
// partials over blocks in a fixed order (one warp per output, fixed
// strided lanes, fixed shuffle tree). No atomics: two calls on the same
// inputs give bitwise-identical results.
//
// What bounds them on the H100: at the main-path shapes (B = 20,000,
// dims [30,20,20,20,1], k = 2) K3 does ~227 MFLOP of float32 FMA
// (~3.4 us at 67 TFLOP/s) against 4.8 MB of input (~1.4 us at 3.35 TB/s),
// and K4 about three times K3's work, so both are bound by operations.
// This first version reads both operands of every FMA from shared memory,
// which caps it well below the FMA peak; register tiling of the per-layer
// products and wgmma for the dW contraction are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kReduceThreads = 256;

struct Dims {
    int n;                     // number of layers
    int d[kMaxLayers + 1];     // d[0] input width ... d[n] = 1
};

// exp-form tanh with the +-20 clip (models/module.py _tanh_precise); expf,
// not __expf, to keep float32 accuracy
__device__ __forceinline__ float act_tanh(float x) {
    const float xc = fminf(fmaxf(x, -20.0f), 20.0f);
    return 1.0f - 2.0f / (expf(2.0f * xc) + 1.0f);
}

// Forward of head kk for sample column s.
// in: input rows [d0][P]; hid: where hidden outputs go. With pingpong the
// hidden layers alternate between two buffers of maxH rows (forward only);
// without it layer l's outputs are stored at rows offset sum_{j<l} d[j+1]
// (kept for the backward pass). Returns the scalar head output.
__device__ float mlp_forward(const float* __restrict__ sW, const Dims& D,
                             int k, int kk, const float* in, float* hid,
                             int P, int s, bool pingpong, int maxH) {
    const float* src = in;
    int woff = 0;
    int hoff = 0;
    float y = 0.0f;
    for (int l = 0; l < D.n; ++l) {
        const int din = D.d[l], dout = D.d[l + 1];
        const float* W = sW + woff + kk * din * dout;
        const float* bias = sW + woff + k * din * dout + kk * dout;
        if (l == D.n - 1) {
            float acc = bias[0];
            for (int i = 0; i < din; ++i) acc += src[i * P + s] * W[i];
            y = acc;
        } else {
            float* dst = pingpong ? hid + (l & 1) * maxH * P : hid + hoff * P;
            for (int o = 0; o < dout; ++o) {
                float acc = bias[o];
                for (int i = 0; i < din; ++i)
                    acc += src[i * P + s] * W[i * dout + o];
                dst[o * P + s] = act_tanh(acc);
            }
            src = dst;
            hoff += dout;
        }
        woff += k * din * dout + k * dout;
    }
    return y;
}

// load a [rows x d0] tile of X (row-major [B, d0]) into sIn[d0][P],
// zero-filling rows past the end of the batch
__device__ void load_tile(const float* __restrict__ X, float* sIn, long b0,
                          int rows, int d0, int T, int P) {
    for (int e = threadIdx.x; e < T * d0; e += T) {
        const int ss = e / d0, i = e - ss * d0;
        sIn[i * P + ss] = ss < rows ? X[(b0 + ss) * d0 + i] : 0.0f;
    }
}

__device__ __forceinline__ int pair_index(int i, int j, int k) {
    // position of head pair (i, j), i < j, in the sc block
    return i * k - i * (i + 1) / 2 + (j - i - 1);
}

// per-sample integrand of stat j (stats_layout order)
__device__ float integrand(int j, int t, const float* sY, const float* sw,
                           const float* swl, int k, int T) {
    const float wt = sw[t], wlt = swl[t];
    if (j == 0) return wt;
    if (j == 1) return wlt;
    int r = j - 2;
    if (r < 5 * k) {
        const int grp = r / k, h = r - grp * k;
        const float y = sY[h * T + t], yl = sY[(k + h) * T + t];
        switch (grp) {
            case 0: return y * wt;
            case 1: return y * y * wt;
            case 2: return yl * wlt;
            case 3: return yl * yl * wlt;
            default: {
                const float d = yl - y;
                return d * d * wt;
            }
        }
    }
    r -= 5 * k;
    int i = 0;
    while (r >= k - 1 - i) {
        r -= k - 1 - i;
        ++i;
    }
    const int jj = i + 1 + r;
    return sY[i * T + t] * sY[jj * T + t] * wt;
}

__global__ void stats_fwd_kernel(const float* __restrict__ params,
                                 const float* __restrict__ F,
                                 const float* __restrict__ Fl,
                                 const float* __restrict__ w,
                                 const float* __restrict__ wl,
                                 float* __restrict__ partials, Dims D, int k,
                                 int n_params, int n_stats, int B, int maxH) {
    extern __shared__ float smem[];
    const int T = blockDim.x, P = T + 1, s = threadIdx.x;
    const int d0 = D.d[0];
    float* sW = smem;                // [n_params]
    float* sY = sW + n_params;       // [2][k][T]: Y then Y_l
    float* sw = sY + 2 * k * T;      // [T]
    float* swl = sw + T;             // [T]
    float* sIn = swl + T;            // [d0][P]
    float* sH = sIn + d0 * P;        // [2][maxH][P]

    for (int i = s; i < n_params; i += T) sW[i] = params[i];
    const long b0 = (long)blockIdx.x * T;
    const int rows = (long)B - b0 < T ? (int)((long)B - b0) : T;
    sw[s] = s < rows ? w[b0 + s] : 0.0f;
    swl[s] = s < rows ? wl[b0 + s] : 0.0f;

    for (int pass = 0; pass < 2; ++pass) {
        __syncthreads();
        load_tile(pass ? Fl : F, sIn, b0, rows, d0, T, P);
        __syncthreads();
        for (int kk = 0; kk < k; ++kk)
            sY[(pass * k + kk) * T + s] =
                mlp_forward(sW, D, k, kk, sIn, sH, P, s, true, maxH);
    }
    __syncthreads();

    // stat j is reduced by warp j % nwarps over the tile, in a fixed order
    const int lane = s & 31, warp = s >> 5, nwarps = T >> 5;
    for (int j = warp; j < n_stats; j += nwarps) {
        float acc = 0.0f;
        for (int t = lane; t < T; t += 32)
            acc += integrand(j, t, sY, sw, swl, k, T);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) partials[(size_t)blockIdx.x * n_stats + j] = acc;
    }
}

__global__ void stats_bwd_kernel(const float* __restrict__ params,
                                 const float* __restrict__ F,
                                 const float* __restrict__ Fl,
                                 const float* __restrict__ w,
                                 const float* __restrict__ wl,
                                 const float* __restrict__ dstats,
                                 float* __restrict__ partials, Dims D, int k,
                                 int n_params, int n_stats, int B,
                                 int hid_rows) {
    extern __shared__ float smem[];
    const int T = blockDim.x, P = T + 1, s = threadIdx.x;
    const int d0 = D.d[0], L = D.n;
    float* sW = smem;                    // [n_params]
    float* sGrad = sW + n_params;        // [n_params], thread-owned entries
    float* sDs = sGrad + n_params;       // [n_stats]
    float* sY = sDs + n_stats;           // [2][k][T]
    float* sw = sY + 2 * k * T;          // [T]
    float* swl = sw + T;                 // [T]
    float* sIn = swl + T;                // [d0][P]
    float* sAct = sIn + d0 * P;          // hidden outputs [hid_rows][P]
    float* sG = sAct + hid_rows * P;     // layer-output cotangents [hid_rows+1][P]

    for (int i = s; i < n_params; i += T) {
        sW[i] = params[i];
        sGrad[i] = 0.0f;
    }
    for (int i = s; i < n_stats; i += T) sDs[i] = dstats[i];
    const long b0 = (long)blockIdx.x * T;
    const int rows = (long)B - b0 < T ? (int)((long)B - b0) : T;
    const float ws = s < rows ? w[b0 + s] : 0.0f;
    const float wls = s < rows ? wl[b0 + s] : 0.0f;
    sw[s] = ws;
    swl[s] = wls;

    // phase 0: every head's output on both passes (the cotangents couple
    // the heads through sc and the passes through sd)
    for (int pass = 0; pass < 2; ++pass) {
        __syncthreads();
        load_tile(pass ? Fl : F, sIn, b0, rows, d0, T, P);
        __syncthreads();
        for (int kk = 0; kk < k; ++kk)
            sY[(pass * k + kk) * T + s] =
                mlp_forward(sW, D, k, kk, sIn, sAct, P, s, false, 0);
    }

    const int o_s1 = 2, o_s2 = 2 + k, o_s1l = 2 + 2 * k, o_s2l = 2 + 3 * k;
    const int o_sd = 2 + 4 * k, o_sc = 2 + 5 * k;
    int woff_l[kMaxLayers];  // offset of layer l's block in params
    {
        int woff = 0;
        for (int l = 0; l < L; ++l) {
            woff_l[l] = woff;
            woff += k * D.d[l] * D.d[l + 1] + k * D.d[l + 1];
        }
    }

    // phase 1: per pass and head, recompute with stored activations,
    // backpropagate, and add this tile's parameter gradients
    for (int pass = 0; pass < 2; ++pass) {
        __syncthreads();
        load_tile(pass ? Fl : F, sIn, b0, rows, d0, T, P);
        __syncthreads();
        for (int kk = 0; kk < k; ++kk) {
            mlp_forward(sW, D, k, kk, sIn, sAct, P, s, false, 0);
            const float Y = sY[kk * T + s], Yl = sY[(k + kk) * T + s];
            const float dYd = Yl - Y;
            float g;
            if (pass == 0) {
                float cross = 0.0f;
                for (int j = 0; j < k; ++j) {
                    if (j == kk) continue;
                    const int pi = j > kk ? pair_index(kk, j, k)
                                          : pair_index(j, kk, k);
                    cross += sY[j * T + s] * sDs[o_sc + pi];
                }
                g = ws * (sDs[o_s1 + kk] + 2.0f * sDs[o_s2 + kk] * Y -
                          2.0f * sDs[o_sd + kk] * dYd + cross);
            } else {
                g = wls * (sDs[o_s1l + kk] + 2.0f * sDs[o_s2l + kk] * Yl) +
                    2.0f * ws * sDs[o_sd + kk] * dYd;
            }

            // cotangent rows: layer l's outputs start at row goff[l] =
            // sum_{j<l} d[j+1]; the output layer's single row is hid_rows
            sG[hid_rows * P + s] = g;
            int goff_out = hid_rows;
            for (int l = L - 1; l >= 1; --l) {
                const int din = D.d[l], dout = D.d[l + 1];
                const float* W = sW + woff_l[l] + kk * din * dout;
                const int goff_in = goff_out - din;
                const float* gout = sG + goff_out * P;
                const float* ain = sAct + goff_in * P;  // layer l's input
                float* gin = sG + goff_in * P;
                for (int i = 0; i < din; ++i) {
                    float acc = 0.0f;
                    for (int o = 0; o < dout; ++o)
                        acc += W[i * dout + o] * gout[o * P + s];
                    const float a = ain[i * P + s];
                    gin[i * P + s] = acc * (1.0f - a * a);
                }
                goff_out = goff_in;
            }
            __syncthreads();

            // dW_t[l][i][o] += sum_t in_l[i][t] * g_l[o][t]; db += sum_t g
            int goff = 0;
            for (int l = 0; l < L; ++l) {
                const int din = D.d[l], dout = D.d[l + 1];
                const float* ain =
                    l == 0 ? sIn : sAct + (goff - din) * P;
                const float* gout = sG + goff * P;
                const int nw = din * dout;
                float* gW = sGrad + woff_l[l] + kk * nw;
                float* gb = sGrad + woff_l[l] + k * nw + kk * dout;
                for (int p = s; p < nw + dout; p += T) {
                    float acc = 0.0f;
                    if (p < nw) {
                        const int i = p / dout, o = p - i * dout;
                        for (int t = 0; t < T; ++t)
                            acc += ain[i * P + t] * gout[o * P + t];
                        gW[p] += acc;
                    } else {
                        const int o = p - nw;
                        for (int t = 0; t < T; ++t) acc += gout[o * P + t];
                        gb[o] += acc;
                    }
                }
                goff += dout;
            }
            __syncthreads();
        }
    }

    for (int i = s; i < n_params; i += T)
        partials[(size_t)blockIdx.x * n_params + i] = sGrad[i];
}

// out[j] = sum over blocks of partials[b][j], one warp per output, in a
// fixed order (lane-strided sums, then a fixed shuffle tree)
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int nblocks,
                                       int n) {
    const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (j >= n) return;
    float acc = 0.0f;
    for (int b = lane; b < nblocks; b += 32) acc += partials[(size_t)b * n + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[j] = acc;
}

bool make_dims(const int* dims, int n_layers, Dims* D) {
    if (n_layers < 1 || n_layers > kMaxLayers) return false;
    D->n = n_layers;
    for (int i = 0; i <= n_layers; ++i) D->d[i] = dims[i];
    return D->d[n_layers] == 1;
}

int launch_reduce(const float* partials, float* out, int nblocks, int n,
                  cudaStream_t stream) {
    const int warps_per_block = kReduceThreads / 32;
    const int grid = (n + warps_per_block - 1) / warps_per_block;
    reduce_partials_kernel<<<grid, kReduceThreads, 0, stream>>>(
        partials, out, nblocks, n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`, no synchronization; return cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for dims the kernels do not take.
// partials must hold ceil(B / tile) * n_stats (fwd) or * n_params (bwd)
// floats; smem_bytes is the dynamic shared memory of the block, computed
// by the caller from the layout above.

int cvf_stats_fwd(const float* params, const float* F, const float* Fl,
                  const float* w, const float* wl, float* partials,
                  float* stats, const int* dims, int n_layers, int k, int B,
                  int tile, int smem_bytes, void* stream) {
    Dims D;
    if (!make_dims(dims, n_layers, &D) || B <= 0 || tile % 32 != 0)
        return (int)cudaErrorInvalidValue;
    int n_params = 0, maxH = 0;
    for (int l = 0; l < n_layers; ++l) {
        n_params += k * D.d[l] * D.d[l + 1] + k * D.d[l + 1];
        if (l < n_layers - 1 && D.d[l + 1] > maxH) maxH = D.d[l + 1];
    }
    const int n_stats = 2 + 5 * k + k * (k - 1) / 2;
    cudaError_t err = cudaFuncSetAttribute(
        stats_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const int nblocks = (B + tile - 1) / tile;
    cudaStream_t st = (cudaStream_t)stream;
    stats_fwd_kernel<<<nblocks, tile, smem_bytes, st>>>(
        params, F, Fl, w, wl, partials, D, k, n_params, n_stats, B, maxH);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_reduce(partials, stats, nblocks, n_stats, st);
}

int cvf_stats_bwd(const float* params, const float* F, const float* Fl,
                  const float* w, const float* wl, const float* dstats,
                  float* partials, float* grads, const int* dims,
                  int n_layers, int k, int B, int tile, int smem_bytes,
                  void* stream) {
    Dims D;
    if (!make_dims(dims, n_layers, &D) || B <= 0 || tile % 32 != 0)
        return (int)cudaErrorInvalidValue;
    int n_params = 0, hid_rows = 0;
    for (int l = 0; l < n_layers; ++l) {
        n_params += k * D.d[l] * D.d[l + 1] + k * D.d[l + 1];
        if (l < n_layers - 1) hid_rows += D.d[l + 1];
    }
    const int n_stats = 2 + 5 * k + k * (k - 1) / 2;
    cudaError_t err = cudaFuncSetAttribute(
        stats_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const int nblocks = (B + tile - 1) / tile;
    cudaStream_t st = (cudaStream_t)stream;
    stats_bwd_kernel<<<nblocks, tile, smem_bytes, st>>>(
        params, F, Fl, w, wl, dstats, partials, D, k, n_params, n_stats, B,
        hid_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_reduce(partials, grads, nblocks, n_params, st);
}

}  // extern "C"
