// FlowNetC correlation backward (K2), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel vec_vad_tpu/models/flownet/ops.py:197-314
// (`_corr_bwd_kernel` / `correlation_bwd_pallas`). Computes exactly what
// `correlation_bwd_ref` computes (vec_vad_torch/models/flownet/ops.py):
//
//   grad_a[b, y, x, c] = (1/C) * sum_{i,j} g[b, y, x, i*n + j]           * b[b, y + dy_i, x + dx_j, c]
//   grad_b[b, y, x, c] = (1/C) * sum_{i,j} g[b, y - dy_i, x - dx_j, i*n + j] * a[b, y - dy_i, x - dx_j, c]
//   dy_i = -max_disp + i*stride, dx_j = -max_disp + j*stride, n = 2*max_disp/stride + 1
//
// with every operand zero outside the frame, no recompute of the forward,
// f32 accumulation and the grads stored in the input dtype (f32 or bf16).
// NHWC in, NHWC out, all tensors contiguous.
//
// Bound at the training shape (8, 48, 64, 256) f32, n = 21 (D = 441):
//   operations: the in-frame products of both grads, 2 * 2 * 8*788*1124*256
//               = 7.3 GFLOP -> ~0.11 ms at the 67 TFLOP/s f32 CUDA-core peak;
//   bytes:      g (43 MB), a and b (25 MB each) read, two grads (25 MB each)
//               written = 144 MB -> ~0.04 ms at 3.35 TB/s.
// So it is compute-bound in f32, like K1: the products have to come from
// on-chip memory, with each output written once.
//
// Design (simple and right first; the TPU kernel's sequential dy grid axis
// has no counterpart, since blocks run in no order):
//   * gather form for both grads: every output element is summed by one
//     thread over all n*n displacements and written once, so there are no
//     atomics and no second pass. grad_b walks, for each dy row, the source
//     row y - dy and the source pixels x - dx;
//   * one block per (batch item, grad, output row y, 32-pixel x-tile,
//     32-channel slice) -> 2 * 8 * 48 * 2 * 8 = 12288 blocks of 256 threads
//     at the training shape; the channel slices of one tile are neighbours
//     in launch order, so the cotangent rows they share come from L2;
//   * per dy row whose source row lies in the frame, the block stages in
//     shared memory the other operand's row segment (tile + 2*max_disp
//     halo, zero outside the frame), transposed to [channel][pixel] with an
//     odd pitch, and the n cotangents each lane pairs with it;
//   * lane = output pixel, warp w owns channels w, w+8, w+16, w+24: a
//     thread holds its n cotangents in registers and keeps 4 f32
//     accumulators across all dy rows; the epilogue transposes the tile
//     through shared memory so the stores run along channels.
// Limits (checked here and by the Python wrapper): n <= 24, 48 KB of
// shared memory (max_disp <= 148), H and 2 * B <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;           // output pixels of one row per block (one per lane)
constexpr int NWARP = 8;         // warps per block
constexpr int CPT = 4;           // channels per thread
constexpr int CK = NWARP * CPT;  // channels per block
constexpr int NMAX = 24;         // largest displacement grid side

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(TX * NWARP)
corr_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ g, T* __restrict__ grad_a,
                T* __restrict__ grad_b, int H, int W, int C, int max_disp,
                int stride, int n_disp, int n_xtiles)
{
    extern __shared__ float smem[];
    const int seg = TX + 2 * max_disp;          // source row segment incl. halo
    const int o_pitch = seg + 1;                // odd pitches: no bank conflicts
    const int g_pitch = TX + 1;
    float* o_s = smem;                          // [CK][o_pitch]
    float* g_s = smem + CK * o_pitch;           // [n_disp][g_pitch]

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int x0 = (blockIdx.x % n_xtiles) * TX;
    const int c0 = (blockIdx.x / n_xtiles) * CK;
    const int y = blockIdx.y;
    const int bi = blockIdx.z >> 1;
    const bool wrt_b = blockIdx.z & 1;          // uniform across the block
    const int D = n_disp * n_disp;
    const long long img = (long long)bi * H * W;   // first pixel of this item
    const T* other = wrt_b ? a : b;
    T* out = wrt_b ? grad_b : grad_a;
    // segment position of displacement j for this lane: grad_a reads b at
    // x + dx_j, grad_b reads a at x - dx_j; the segment starts at x0 - max_disp
    const int pos0 = wrt_b ? lane + 2 * max_disp : lane;
    const int step = wrt_b ? -stride : stride;

    float acc[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[k] = 0.f;

    for (int i = 0; i < n_disp; ++i) {
        const int dy = -max_disp + i * stride;
        const int yy = wrt_b ? y - dy : y + dy;     // the source row
        if (yy < 0 || yy >= H) continue;            // all zero: skip the row
        __syncthreads();                            // last row done reading smem
        for (int t = threadIdx.x; t < seg * CK; t += blockDim.x) {
            const int p = t / CK, c = t % CK;
            const int xs = x0 - max_disp + p;
            float v = 0.f;
            if (xs >= 0 && xs < W && c0 + c < C)
                v = to_f32(other[(img + (long long)yy * W + xs) * C + c0 + c]);
            o_s[c * o_pitch + p] = v;
        }
        // grad_a pairs lane x with g[y, x, i*n + j]; grad_b with
        // g[y - dy, x - dx_j, i*n + j] (zero where that pixel is outside)
        const long long g_row = img + (long long)(wrt_b ? yy : y) * W;
        for (int t = threadIdx.x; t < n_disp * TX; t += blockDim.x) {
            const int j = t / TX, p = t % TX;
            const int gx = wrt_b ? x0 + p + max_disp - j * stride : x0 + p;
            float v = 0.f;
            if (x0 + p < W && gx >= 0 && gx < W)
                v = to_f32(g[(g_row + gx) * D + i * n_disp + j]);
            g_s[j * g_pitch + p] = v;
        }
        __syncthreads();
        float gr[NMAX];
#pragma unroll
        for (int j = 0; j < NMAX; ++j)
            gr[j] = j < n_disp ? g_s[j * g_pitch + lane] : 0.f;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
            const float* row = o_s + (warp + k * NWARP) * o_pitch + pos0;
#pragma unroll
            for (int j = 0; j < NMAX; ++j)
                if (j < n_disp) acc[k] = fmaf(gr[j], row[j * step], acc[k]);
        }
    }

    // epilogue: [pixel][channel] through shared memory, stores along C
    float* out_s = smem;                        // [TX][CK + 1] fits in o_s
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CPT; ++k)
        out_s[lane * (CK + 1) + warp + k * NWARP] = acc[k] / (float)C;
    __syncthreads();
    for (int t = threadIdx.x; t < TX * CK; t += blockDim.x) {
        const int p = t / CK, c = t % CK;
        if (x0 + p < W && c0 + c < C)
            store(out + (img + (long long)y * W + x0 + p) * C + c0 + c,
                  out_s[p * (CK + 1) + c]);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; a, b, g and both grads share it.
// One launch computes both grads. Returns cudaGetLastError() after the
// launch (0 on success); never synchronises.
extern "C" int vv_correlation_bwd(const void* a, const void* b, const void* g,
                                  void* grad_a, void* grad_b, int dtype,
                                  int B, int H, int W, int C, int max_disp,
                                  int stride, void* stream)
{
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || max_disp < 0 || stride <= 0)
        return (int)cudaErrorInvalidValue;
    const int n_disp = 2 * max_disp / stride + 1;
    const size_t smem = sizeof(float) *
        (CK * (TX + 2 * max_disp + 1) + n_disp * (TX + 1));
    if (n_disp > NMAX || smem > 48 * 1024 || H > 65535 || 2LL * B > 65535)
        return (int)cudaErrorInvalidValue;
    const int n_xtiles = (W + TX - 1) / TX;
    const int n_slices = (C + CK - 1) / CK;
    const dim3 grid(n_xtiles * n_slices, H, 2 * B);
    const dim3 block(TX * NWARP);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        corr_bwd_kernel<float><<<grid, block, smem, s>>>(
            (const float*)a, (const float*)b, (const float*)g, (float*)grad_a,
            (float*)grad_b, H, W, C, max_disp, stride, n_disp, n_xtiles);
    } else if (dtype == 1) {
        corr_bwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
            (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
            (const __nv_bfloat16*)g, (__nv_bfloat16*)grad_a,
            (__nv_bfloat16*)grad_b, H, W, C, max_disp, stride, n_disp, n_xtiles);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
