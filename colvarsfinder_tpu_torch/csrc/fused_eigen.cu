// Fused transfer-operator statistics kernels for Hopper (sm_90a), plain C
// interface loaded with ctypes by colvarsfinder_tpu_torch/ops/_cuda.py.
//
// cvf_stats_fwd (K3) replaces _fwd_kernel_factory in
// colvarsfinder_tpu/ops/fused_eigen.py:146-215 (launched at :437): the k-head
// tanh MLP on F and F_l [B, d] reduced to the stats vector
//   tw, twl, s1[k], s2[k], s1l[k], s2l[k], sd[k], sc[k(k-1)/2]
// in stats_layout order (fused_eigen.py:72-81). It also writes the head
// outputs Y [2, k, B] (pass, head, sample) for the backward.
// cvf_stats_bwd (K4) replaces _bwd_kernel_factory (:230-321, launched at
// :486): from dL/dstats and K3's Y it forms the per-sample output
// cotangents (:290-299), runs one forward of a head to get its hidden
// activations, backpropagates through it and accumulates dW, db. The data
// inputs get no gradient.
//
// Layouts. params (and grads) are one flat float32 buffer; for each layer l
// it holds W_t[l] [k, d_l, d_{l+1}] then b[l] [k, d_{l+1}] (the transposed
// weight layout of params_t_of). The last layer has d_L = 1. Per-sample rows
// live in shared memory as [width][T + 1]: the +1 puts rows read at the same
// sample column on different banks.
//
// K3. What bounds it on the H100: at the main-path shapes it must do
// ~227 MFLOP of float32 FMA (3.4 us at 67 TFLOP/s) and move ~5 MB (1.5 us),
// so it is bound by operations. Its first design ran one thread per sample
// through every head, one dependent shared-memory FMA chain per thread, the
// failure described for K4 below. It now runs K4's hidden-layer forward:
//   - one block per sample tile (T = 32 or 64), 4 threads per sample, all k
//     heads inside the block, so the stats, which couple the heads (sc) and
//     the passes (sd), are still reduced in the block; the heads run one
//     after another through the hidden layers with rows_forward, a warp
//     owning 4 rows over the tile, broadcast float4 weight loads;
//   - the weights are copied by cp.async into a per-head layout (per layer
//     and head W_t then b, as K4 keeps one head), in the same n_params floats;
//   - the width-1 output layer splits each sample's sum over its 4 threads;
//   - one input buffer and two ping-pong hidden buffers: the block is no
//     larger than the first design's, so every model it took still fits at
//     the 32-sample tile; F_l's copy into the input buffer starts as soon as
//     the last head has read F, and overlaps that head's other layers.
// At B = 20,000 the 64-sample tile gives 313 blocks, one wave of 3 per SM;
// the busiest SMs are then bound by instruction issue, and the hidden
// layers' tanh takes about a sixth of the kernel's time.
//
// K4. What bounds it on the H100: at the main-path shapes (B = 20,000,
// dims [30,20,20,20,1], k = 2) it must do ~586 MFLOP of float32 FMA (8.7 us
// at 67 TFLOP/s) and move ~5 MB (1.5 us), so it is bound by operations.
// Every product reads its operands from shared memory, and the first
// design (one thread per sample, all heads in one block, 4-8 warps per SM)
// ran one long dependent chain of shared-memory FMAs per thread: the time
// was one thread's latency, not the card's rate. This design spreads the
// work over many more warps and makes each load feed several FMAs:
//   - one block per (sample tile of T = 64, head), both passes inside the
//     block; the block holds only its head's weights, ~50 KB of shared
//     memory at the main shapes; __launch_bounds__ leave 80 registers a
//     thread, so 3 blocks (24 warps) are resident per SM;
//   - 4 threads per sample (256 threads): in each layer's forward and in
//     the cotangent backprop a warp owns 4 rows over the tile, each lane
//     4 x (T/32) independent accumulators; where a layer's rows are
//     16-byte aligned, a row's 4 weights are one broadcast float4 load;
//   - the dW contraction gives a lane pair a 4 x 4 register tile of
//     (input row, output) entries (the bias is the input row of ones); the
//     two lanes walk the even and the odd samples, 8 loads for 16 FMAs,
//     and add their halves with one shuffle;
//   - no second forward: K3 saved the head outputs Y, so the cotangents
//     come straight from Y, and each (pass, head) runs its forward once;
//   - all global loads are cp.async copies in flight together.
// The ragged tail is masked: missing samples read zeros and carry weight 0,
// so they add nothing to any statistic or gradient; the caller's tensors
// are never padded.
//
// Determinism. TPU grids run in order and the Pallas kernels accumulate
// every tile into one output block. CUDA blocks run in no order, so each
// block writes its own partial vector (K4: its head's slice of the tile's
// row) and a second launch reduces the partials over sample tiles in a
// fixed order (one warp per output, fixed strided lanes, fixed shuffle
// tree). Every sum inside a block also runs in a fixed order. No atomics:
// two calls on the same inputs give bitwise-identical results.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kReduceThreads = 256;
constexpr int kDI = 4;  // K4 dW: input rows per lane-pair tile
constexpr int kDJ = 4;  // K4 dW: outputs per lane-pair tile

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

// asynchronous 4-byte global -> shared copy (cp.async, sm_80+); with valid
// false nothing is read and the destination gets 0. All of a thread's copies
// are in flight together until cp_async_wait_all.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// cp.async a [rows x d0] tile of X (row-major [B, d0]) into sIn[d0][P],
// zero-filling rows past the end of the batch
__device__ void load_tile(const float* __restrict__ X, float* sIn,
                                long b0, int rows, int d0, int T, int P) {
    for (int e = threadIdx.x; e < T * d0; e += blockDim.x) {
        const int ss = e / d0, i = e - ss * d0;
        const bool valid = ss < rows;
        cp_async_f32(sIn + i * P + ss, valid ? X + (b0 + ss) * d0 + i : X,
                     valid);
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

__device__ __forceinline__ float lane_of(const float4& v, int u) {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// K3 and K4 forward of one hidden layer over a tile of T = 32 * RT samples:
//   out[o][t] = tanh(b[o] + sum_i in[i][t] * W_t[i][o]),  W_t [din][dout]
// then b [dout] at W. Warp w owns rows 4w.. (then 4(w + nwarps), ...), lane
// the samples lane + 32 r; the sum over i runs in order. With VEC (dout % 4
// == 0 and W 16-byte aligned) a row's four weights are one broadcast float4
// load.
template <int RT, bool VEC>
__device__ __forceinline__ void rows_forward(const float* in, int din,
                                             const float* W, int dout,
                                             float* out) {
    constexpr int P = 32 * RT + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const float* bias = W + din * dout;
    for (int o0 = warp * 4; o0 < dout; o0 += nwarps * 4) {
        int oc[4];
        float acc[4][RT];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            oc[j] = min(o0 + j, dout - 1);
#pragma unroll
            for (int r = 0; r < RT; ++r) acc[j][r] = bias[oc[j]];
        }
#pragma unroll 4
        for (int i = 0; i < din; ++i) {
            float x[RT], wv[4];
#pragma unroll
            for (int r = 0; r < RT; ++r) x[r] = in[i * P + lane + 32 * r];
            if constexpr (VEC) {
                const float4 w4 =
                    *reinterpret_cast<const float4*>(W + i * dout + o0);
#pragma unroll
                for (int j = 0; j < 4; ++j) wv[j] = lane_of(w4, j);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) wv[j] = W[i * dout + oc[j]];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < RT; ++r)
                    acc[j][r] = fmaf(x[r], wv[j], acc[j][r]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (o0 + j >= dout) break;
#pragma unroll
            for (int r = 0; r < RT; ++r)
                out[(o0 + j) * P + lane + 32 * r] = act_tanh(acc[j][r]);
        }
    }
}

// K3 output layer (width 1, no activation) over the tile:
//   y[t] = b + sum_i in[i][t] W_t[i],  W_t [din] then b
// The 4 threads of sample t = tid / 4 take the rows i = tid % 4 + 4m and
// add their parts with two fixed shuffles.
__device__ __forceinline__ void out_forward(const float* in, int din,
                                            const float* W, float* y,
                                            int P) {
    const int t = threadIdx.x >> 2, q = threadIdx.x & 3;
    float acc = 0.0f;
    for (int i = q; i < din; i += 4) acc = fmaf(in[i * P + t], W[i], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (q == 0) y[t] = W[din] + acc;
}

// K3: one block per sample tile of T = 32 * RT, all k heads, 4 * T
// threads; shared memory in the order below (stats_smem_bytes in
// ops/fused_eigen.py mirrors it)
template <int RT>
__global__ void __launch_bounds__(128 * RT, 6 / RT)
stats_fwd_kernel(const float* __restrict__ params,
                 const float* __restrict__ F, const float* __restrict__ Fl,
                 const float* __restrict__ w, const float* __restrict__ wl,
                 float* __restrict__ partials, float* __restrict__ Y, Dims D,
                 int k, int n_params, int n_stats, int B, int maxH) {
    constexpr int T = 32 * RT, P = T + 1;
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, NT = blockDim.x;
    const int d0 = D.d[0], L = D.n;
    // layer l's block has k * (d_l + 1) * d_{l+1} floats in params and in
    // sW alike; in sW it holds per head W_t [d_l][d_{l+1}] then b [d_{l+1}]
    float* sW = smem;                // [n_params]
    float* sY = sW + n_params;       // [2][k][T]: Y then Y_l
    float* sw = sY + 2 * k * T;      // [T]
    float* swl = sw + T;             // [T]
    float* sIn = swl + T;            // [d0][P]
    float* sH = sIn + d0 * P;        // [2][maxH][P]

    // the data first (from device memory), then the weights (from L2)
    const long b0 = (long)blockIdx.x * T;
    const int rows = (long)B - b0 < T ? (int)((long)B - b0) : T;
    if (tid < T) {
        const bool v = tid < rows;
        cp_async_f32(sw + tid, v ? w + b0 + tid : w, v);
        cp_async_f32(swl + tid, v ? wl + b0 + tid : wl, v);
    }
    load_tile(F, sIn, b0, rows, d0, T, P);
    for (int l = 0, off = 0; l < L; ++l) {
        const int dout = D.d[l + 1], nw = D.d[l] * dout, nh = nw + dout;
        for (int kk = 0; kk < k; ++kk) {
            const float* gW = params + off + kk * nw;
            const float* gb = params + off + k * nw + kk * dout;
            for (int e = tid; e < nh; e += NT)
                cp_async_f32(sW + off + kk * nh + e,
                             e < nw ? gW + e : gb + (e - nw), true);
        }
        off += k * nh;
    }

    for (int pass = 0; pass < 2; ++pass) {
        cp_async_wait_all();
        __syncthreads();
        for (int kk = 0; kk < k; ++kk) {
            // sIn is free once the last head of pass 0 has read it (in its
            // first layer): F_l's copy then overlaps that head's other layers
            const bool load_fl = pass == 0 && kk == k - 1;
            const float* src = sIn;
            int off = 0;
            for (int l = 0; l + 1 < L; ++l) {
                const int din = D.d[l], dout = D.d[l + 1];
                const float* W = sW + off + kk * (din + 1) * dout;
                float* dst = sH + (l & 1) * maxH * P;
                if (dout % 4 == 0 && off % 4 == 0)
                    rows_forward<RT, true>(src, din, W, dout, dst);
                else
                    rows_forward<RT, false>(src, din, W, dout, dst);
                __syncthreads();
                if (load_fl && l == 0) load_tile(Fl, sIn, b0, rows, d0, T, P);
                src = dst;
                off += k * (din + 1) * dout;
            }
            const int din = D.d[L - 1];
            out_forward(src, din, sW + off + kk * (din + 1),
                        sY + (pass * k + kk) * T, P);
            __syncthreads();
            if (load_fl && L == 1) load_tile(Fl, sIn, b0, rows, d0, T, P);
        }
    }

    // the head outputs, for K4: one coalesced row per (pass, head)
    for (int e = tid; e < 2 * k * T; e += NT) {
        const int pk = e / T, t = e - pk * T;
        if (t < rows) Y[(size_t)pk * B + b0 + t] = sY[e];
    }

    // stat j is reduced by warp j % nwarps over the tile, in a fixed order
    const int lane = tid & 31, warp = tid >> 5, nwarps = NT >> 5;
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

// K4 cotangent of a layer's inputs over the tile:
//   out[i][t] = (sum_o W_t[i][o] g[o][t]) * (1 - a[i][t]^2)
// Warp w owns rows 4w.., lane the samples lane + 32 r; the sum over o runs
// in order. With VEC it runs in chunks of four outputs, each row's four
// weights one float4 load.
template <int RT, bool VEC>
__device__ __forceinline__ void rows_backward(const float* g, int dout,
                                              const float* W, int din,
                                              float* out, const float* a) {
    constexpr int P = 32 * RT + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int i0 = warp * 4; i0 < din; i0 += nwarps * 4) {
        const float* Wr[4];
        float acc[4][RT];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            Wr[q] = W + min(i0 + q, din - 1) * dout;
#pragma unroll
            for (int r = 0; r < RT; ++r) acc[q][r] = 0.0f;
        }
        if constexpr (VEC) {
#pragma unroll 2
            for (int c = 0; c < dout; c += 4) {
                float4 w4[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    w4[q] = *reinterpret_cast<const float4*>(Wr[q] + c);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    float x[RT];
#pragma unroll
                    for (int r = 0; r < RT; ++r)
                        x[r] = g[(c + u) * P + lane + 32 * r];
#pragma unroll
                    for (int q = 0; q < 4; ++q)
#pragma unroll
                        for (int r = 0; r < RT; ++r)
                            acc[q][r] =
                                fmaf(x[r], lane_of(w4[q], u), acc[q][r]);
                }
            }
        } else {
#pragma unroll 4
            for (int o = 0; o < dout; ++o) {
                float x[RT];
#pragma unroll
                for (int r = 0; r < RT; ++r) x[r] = g[o * P + lane + 32 * r];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float wv = Wr[q][o];
#pragma unroll
                    for (int r = 0; r < RT; ++r)
                        acc[q][r] = fmaf(x[r], wv, acc[q][r]);
                }
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (i0 + q >= din) break;
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const int idx = (i0 + q) * P + lane + 32 * r;
                const float av = a[idx];
                out[idx] = acc[q][r] * (1.0f - av * av);
            }
        }
    }
}

// one block per (sample tile of T = 32 * RT, head blockIdx.y), 4 * T
// threads; shared memory in the order below (stats_smem_bytes in
// ops/fused_eigen.py mirrors it)
template <int RT>
__global__ void __launch_bounds__(128 * RT, 6 / RT)
stats_bwd_kernel(const float* __restrict__ params,
                 const float* __restrict__ F, const float* __restrict__ Fl,
                 const float* __restrict__ w, const float* __restrict__ wl,
                 const float* __restrict__ Y,
                 const float* __restrict__ dstats,
                 float* __restrict__ partials, Dims D, int k, int n_params,
                 int B, int hid_rows) {
    constexpr int T = 32 * RT, P = T + 1;
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, NT = blockDim.x;
    const int kk = blockIdx.y;
    const int d0 = D.d[0], L = D.n;

    // woff: layer l's block in params (all heads); hoff: in the head's
    // compact copy (W_t [din][dout] then b [dout] per layer); goff: row of
    // layer l's outputs in sG (and, for hidden layers, at d0 + goff in
    // sAct); the output layer's row is hid_rows + pass
    int woff[kMaxLayers], hoff[kMaxLayers], goff[kMaxLayers];
    int n_head = 0, n_tiles = 0;
    {
        int wo = 0, go = 0;
        for (int l = 0; l < L; ++l) {
            const int din = D.d[l], dout = D.d[l + 1];
            woff[l] = wo;
            hoff[l] = n_head;
            goff[l] = go;
            wo += k * (din * dout + dout);
            n_head += din * dout + dout;
            go += dout;
            n_tiles += ((din + kDI) / kDI) * ((dout + kDJ - 1) / kDJ);
        }
    }

    float* sW = smem;                        // [n_head]
    float* sGrad = sW + n_head;              // [n_head], thread-owned
    float* sOnes = sGrad + n_head;           // [T], the bias's input row
    float* sAct = sOnes + T;                 // [d0 + hid_rows][P]
    float* sG = sAct + (d0 + hid_rows) * P;  // [hid_rows + 2][P]

    for (int l = 0; l < L; ++l) {
        const int din = D.d[l], dout = D.d[l + 1], nw = din * dout;
        const float* gW = params + woff[l] + kk * nw;
        const float* gb = params + woff[l] + k * nw + kk * dout;
        for (int e = tid; e < nw + dout; e += NT) {
            cp_async_f32(sW + hoff[l] + e, e < nw ? gW + e : gb + (e - nw),
                         true);
            sGrad[hoff[l] + e] = 0.0f;
        }
    }
    const long b0 = (long)blockIdx.x * T;
    const int rows = (long)B - b0 < T ? (int)((long)B - b0) : T;
    load_tile(F, sAct, b0, rows, d0, T, P);
    if (tid < T) {
        // this head's output cotangent for sample tid on both passes, from
        // K3's head outputs (the cotangents couple the heads through sc and
        // the passes through sd); missing samples carry weight 0
        const int t = tid;
        const bool v = t < rows;
        const long b = b0 + (v ? t : 0);
        const float ws = v ? w[b] : 0.0f, wls = v ? wl[b] : 0.0f;
        const float Yv = v ? Y[(size_t)kk * B + b] : 0.0f;
        const float Yl = v ? Y[(size_t)(k + kk) * B + b] : 0.0f;
        const float* ds = dstats;
        const int o_s1 = 2, o_s2 = 2 + k, o_s1l = 2 + 2 * k;
        const int o_s2l = 2 + 3 * k, o_sd = 2 + 4 * k, o_sc = 2 + 5 * k;
        const float dYd = Yl - Yv;
        float cross = 0.0f;
        for (int j = 0; j < k; ++j) {
            if (j == kk) continue;
            const int pi = j > kk ? pair_index(kk, j, k) : pair_index(j, kk, k);
            cross += (v ? Y[(size_t)j * B + b] : 0.0f) * ds[o_sc + pi];
        }
        sG[hid_rows * P + t] =
            ws * (ds[o_s1 + kk] + 2.0f * ds[o_s2 + kk] * Yv -
                  2.0f * ds[o_sd + kk] * dYd + cross);
        sG[(hid_rows + 1) * P + t] =
            wls * (ds[o_s1l + kk] + 2.0f * ds[o_s2l + kk] * Yl) +
            2.0f * ws * ds[o_sd + kk] * dYd;
        sOnes[t] = 1.0f;
    }

    for (int pass = 0; pass < 2; ++pass) {
        if (pass) {
            // pass 0's dW is done with the input rows
            __syncthreads();
            load_tile(Fl, sAct, b0, rows, d0, T, P);
        }
        cp_async_wait_all();
        __syncthreads();
        goff[L - 1] = hid_rows + pass;

        // forward through the hidden layers (the output layer's value is Y)
        for (int l = 0; l < L - 1; ++l) {
            const int din = D.d[l], dout = D.d[l + 1];
            const float* ain = sAct + (l == 0 ? 0 : d0 + goff[l - 1]) * P;
            float* aout = sAct + (d0 + goff[l]) * P;
            if (dout % 4 == 0 && hoff[l] % 4 == 0)
                rows_forward<RT, true>(ain, din, sW + hoff[l], dout, aout);
            else
                rows_forward<RT, false>(ain, din, sW + hoff[l], dout, aout);
            __syncthreads();
        }

        // cotangents of the hidden layers' outputs, last layer first:
        // g_{l-1}[i][t] = (sum_o W_t[l][i][o] g_l[o][t]) * (1 - a[i][t]^2)
        for (int l = L - 1; l >= 1; --l) {
            const int din = D.d[l], dout = D.d[l + 1];
            const float* gl = sG + goff[l] * P;
            float* gin = sG + goff[l - 1] * P;
            const float* a = sAct + (d0 + goff[l - 1]) * P;
            if (dout % 4 == 0 && hoff[l] % 4 == 0)
                rows_backward<RT, true>(gl, dout, sW + hoff[l], din, gin, a);
            else
                rows_backward<RT, false>(gl, dout, sW + hoff[l], din, gin, a);
            __syncthreads();
        }

        // dW_t[l][i][o] += sum_t in_l[i][t] g_l[o][t]; the bias is row
        // i = din with in = 1, which lands on b[l][o] in the compact layout.
        // A lane pair owns a kDI x kDJ tile, the even and the odd samples
        // one lane each, and sums the two halves with one shuffle; each
        // entry belongs to the same pair in both passes.
        const int h = tid & 1;
        const unsigned pair = 3u << (tid & 30);
        for (int wt = tid >> 1; wt < n_tiles; wt += NT >> 1) {
            int l = 0, r = wt, din, dout, n_ot;
            for (;;) {
                din = D.d[l];
                dout = D.d[l + 1];
                n_ot = (dout + kDJ - 1) / kDJ;
                const int n = ((din + kDI) / kDI) * n_ot;
                if (r < n) break;
                r -= n;
                ++l;
            }
            const int it = r / n_ot, ot = r - it * n_ot;
            const int i0 = it * kDI, o0 = ot * kDJ;
            const float* ain = sAct + (l == 0 ? 0 : d0 + goff[l - 1]) * P;
            const float* arow[kDI];
            const float* grow[kDJ];
#pragma unroll
            for (int a = 0; a < kDI; ++a) {
                const int i = min(i0 + a, din);
                arow[a] = i == din ? sOnes : ain + i * P;
            }
#pragma unroll
            for (int j = 0; j < kDJ; ++j)
                grow[j] = sG + (goff[l] + min(o0 + j, dout - 1)) * P;
            float acc[kDI][kDJ];
#pragma unroll
            for (int a = 0; a < kDI; ++a)
#pragma unroll
                for (int j = 0; j < kDJ; ++j) acc[a][j] = 0.0f;
#pragma unroll 4
            for (int t = h; t < T; t += 2) {
                float av[kDI], gv[kDJ];
#pragma unroll
                for (int a = 0; a < kDI; ++a) av[a] = arow[a][t];
#pragma unroll
                for (int j = 0; j < kDJ; ++j) gv[j] = grow[j][t];
#pragma unroll
                for (int a = 0; a < kDI; ++a)
#pragma unroll
                    for (int j = 0; j < kDJ; ++j)
                        acc[a][j] = fmaf(av[a], gv[j], acc[a][j]);
            }
#pragma unroll
            for (int a = 0; a < kDI; ++a)
#pragma unroll
                for (int j = 0; j < kDJ; ++j)
                    acc[a][j] += __shfl_xor_sync(pair, acc[a][j], 1);
            if (h) continue;
            float* dst = sGrad + hoff[l];
#pragma unroll
            for (int a = 0; a < kDI; ++a) {
                if (i0 + a > din) break;
#pragma unroll
                for (int j = 0; j < kDJ; ++j)
                    if (o0 + j < dout)
                        dst[(i0 + a) * dout + o0 + j] += acc[a][j];
            }
        }
    }
    __syncthreads();

    // this head's slice of the tile's partial gradient row
    float* part = partials + (size_t)blockIdx.x * n_params;
    for (int l = 0; l < L; ++l) {
        const int din = D.d[l], dout = D.d[l + 1], nw = din * dout;
        for (int e = tid; e < nw + dout; e += NT)
            part[e < nw ? woff[l] + kk * nw + e
                        : woff[l] + k * nw + kk * dout + (e - nw)] =
                sGrad[hoff[l] + e];
    }
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

template <int RT>
int launch_bwd(const float* params, const float* F, const float* Fl,
               const float* w, const float* wl, const float* Y,
               const float* dstats, float* partials, const Dims& D, int k,
               int n_params, int B, int hid_rows, int smem_bytes,
               cudaStream_t st) {
    constexpr int T = 32 * RT;
    cudaError_t err = cudaFuncSetAttribute(
        stats_bwd_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + T - 1) / T, k);
    stats_bwd_kernel<RT><<<grid, 4 * T, smem_bytes, st>>>(
        params, F, Fl, w, wl, Y, dstats, partials, D, k, n_params, B,
        hid_rows);
    return (int)cudaGetLastError();
}

template <int RT>
int launch_fwd(const float* params, const float* F, const float* Fl,
               const float* w, const float* wl, float* partials, float* Y,
               const Dims& D, int k, int n_params, int n_stats, int B,
               int maxH, int smem_bytes, cudaStream_t st) {
    constexpr int T = 32 * RT;
    cudaError_t err = cudaFuncSetAttribute(
        stats_fwd_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    stats_fwd_kernel<RT><<<(B + T - 1) / T, 4 * T, smem_bytes, st>>>(
        params, F, Fl, w, wl, partials, Y, D, k, n_params, n_stats, B, maxH);
    return (int)cudaGetLastError();
}

template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem_bytes,
              int* blocks_per_sm) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, threads, smem_bytes);
}

}  // namespace

extern "C" {

// Launch on `stream`, no synchronization; return cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for dims or tiles the kernels do not
// take. partials must hold ceil(B / tile) * n_stats (fwd) or * n_params
// (bwd) floats; Y is [2, k, B]; smem_bytes is the dynamic shared memory of
// the block, computed by the caller from the layouts above. Both kernels
// take a tile of 32 or 64 samples, with 4 threads per sample.

int cvf_stats_fwd(const float* params, const float* F, const float* Fl,
                  const float* w, const float* wl, float* partials,
                  float* stats, float* Y, const int* dims, int n_layers,
                  int k, int B, int tile, int smem_bytes, void* stream) {
    Dims D;
    if (!make_dims(dims, n_layers, &D) || B <= 0 || (tile != 32 && tile != 64))
        return (int)cudaErrorInvalidValue;
    int n_params = 0, maxH = 0;
    for (int l = 0; l < n_layers; ++l) {
        n_params += k * D.d[l] * D.d[l + 1] + k * D.d[l + 1];
        if (l < n_layers - 1 && D.d[l + 1] > maxH) maxH = D.d[l + 1];
    }
    const int n_stats = 2 + 5 * k + k * (k - 1) / 2;
    cudaStream_t st = (cudaStream_t)stream;
    const int err =
        tile == 64
            ? launch_fwd<2>(params, F, Fl, w, wl, partials, Y, D, k, n_params,
                            n_stats, B, maxH, smem_bytes, st)
            : launch_fwd<1>(params, F, Fl, w, wl, partials, Y, D, k, n_params,
                            n_stats, B, maxH, smem_bytes, st);
    if (err != 0) return err;
    return launch_reduce(partials, stats, (B + tile - 1) / tile, n_stats, st);
}
int cvf_stats_bwd(const float* params, const float* F, const float* Fl,
                  const float* w, const float* wl, const float* Y,
                  const float* dstats, float* partials, float* grads,
                  const int* dims, int n_layers, int k, int B, int tile,
                  int smem_bytes, void* stream) {
    Dims D;
    if (!make_dims(dims, n_layers, &D) || B <= 0 || (tile != 32 && tile != 64))
        return (int)cudaErrorInvalidValue;
    int n_params = 0, hid_rows = 0;
    for (int l = 0; l < n_layers; ++l) {
        n_params += k * D.d[l] * D.d[l + 1] + k * D.d[l + 1];
        if (l < n_layers - 1) hid_rows += D.d[l + 1];
    }
    cudaStream_t st = (cudaStream_t)stream;
    const int err =
        tile == 64
            ? launch_bwd<2>(params, F, Fl, w, wl, Y, dstats, partials, D, k,
                            n_params, B, hid_rows, smem_bytes, st)
            : launch_bwd<1>(params, F, Fl, w, wl, Y, dstats, partials, D, k,
                            n_params, B, hid_rows, smem_bytes, st);
    if (err != 0) return err;
    return launch_reduce(partials, grads, (B + tile - 1) / tile, n_params, st);
}

// K3 (fwd) or K4 (bwd) blocks resident on one SM at this tile and shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *blocks_per_sm.
int cvf_stats_fwd_occupancy(int tile, int smem_bytes, int* blocks_per_sm) {
    if (tile == 64)
        return occupancy(stats_fwd_kernel<2>, 256, smem_bytes, blocks_per_sm);
    if (tile == 32)
        return occupancy(stats_fwd_kernel<1>, 128, smem_bytes, blocks_per_sm);
    return (int)cudaErrorInvalidValue;
}

int cvf_stats_bwd_occupancy(int tile, int smem_bytes, int* blocks_per_sm) {
    if (tile == 64)
        return occupancy(stats_bwd_kernel<2>, 256, smem_bytes, blocks_per_sm);
    if (tile == 32)
        return occupancy(stats_bwd_kernel<1>, 128, smem_bytes, blocks_per_sm);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
