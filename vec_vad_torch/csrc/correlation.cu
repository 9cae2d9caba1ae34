// FlowNetC correlation forward (K1), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel vec_vad_tpu/models/flownet/ops.py:73-155
// (`_corr_kernel` / `correlation_pallas`). Computes exactly what
// `correlation_ref` computes (vec_vad_torch/models/flownet/ops.py):
//
//   out[b, y, x, i*n + j] = (1/C) * sum_c a[b, y, x, c] * b[b, y + dy_i, x + dx_j, c]
//   dy_i = -max_disp + i*stride, dx_j = -max_disp + j*stride, n = 2*max_disp/stride + 1
//
// with b zero outside the frame, the displacement channel dy-major (the
// reference CUDA kernel's top_channel order), the channel dot accumulated
// in f32 and the result stored in the input dtype (f32 or bf16). NHWC in,
// NHWC out, all tensors contiguous.
//
// Bound at the serving shape (1, 48, 64, 256) f32, n = 21 (D = 441):
//   operations: 2 * 48*64*441*256 = 0.69 GFLOP -> ~10 us at the 67 TFLOP/s
//               f32 CUDA-core peak (the dot has no tensor-core form in f32);
//   bytes:      2 * 3.1 MB in + 5.4 MB out = 11.7 MB -> ~3.5 us at 3.35 TB/s.
// So the kernel is compute-bound in f32: what matters is keeping the FMA
// pipes fed from on-chip memory, never re-reading device memory per
// displacement.
//
// Design (simple and right first; wgmma/TMA work belongs to later PRs):
//   * one block per (batch item, output row y, 32-pixel x-tile, group of
//     7 displacement rows) -> 2 x 48 x 3 = 288 blocks of 256 threads at
//     the serving shape, about two per SM;
//   * per displacement row dy and per 32-channel slice, the block stages
//     the a-tile (32 px) and the b row segment it needs (32 px + 2*max_disp
//     halo, zero-filled outside the frame) in shared memory, transposed to
//     [channel][pixel] with an odd row pitch so both the staging stores and
//     the compute loads are free of bank conflicts;
//   * lane = output pixel, warp w owns displacements j = w, w+8, w+16: each
//     thread keeps 3 f32 accumulators in registers across all C channels,
//     so every product is computed once and only the final 441 values per
//     pixel go to device memory;
//   * displacement rows wholly outside the frame write zeros without
//     touching b.
// Limits (checked here and by the Python wrapper): n <= 24, 48 KB of
// shared memory (max_disp <= 148), H and B * ceil(n / 7) <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;            // output pixels of one row per block (one per lane)
constexpr int NWARP = 8;          // warps per block
constexpr int JPT = 3;            // displacements per thread: n <= NWARP * JPT
constexpr int CK = 32;            // channels staged per pass
constexpr int DY_PER_BLOCK = 7;   // displacement rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(TX * NWARP)
corr_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, int H, int W, int C, int max_disp,
                int stride, int n_disp, int n_groups)
{
    extern __shared__ float smem[];
    const int seg = TX + 2 * max_disp;          // b row segment incl. halo
    const int a_pitch = TX + 1;                 // odd pitches: no bank conflicts
    const int b_pitch = seg + 1;
    float* a_s = smem;                          // [CK][a_pitch]
    float* b_s = smem + CK * a_pitch;           // [CK][b_pitch]

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int x0 = blockIdx.x * TX;
    const int x = x0 + lane;
    const int y = blockIdx.y;
    const int bi = blockIdx.z / n_groups;
    const int g = blockIdx.z % n_groups;
    const int dy_lo = g * DY_PER_BLOCK;
    const int dy_hi = min(n_disp, dy_lo + DY_PER_BLOCK);
    const int D = n_disp * n_disp;
    const long long img = (long long)bi * H * W;   // first pixel of this item
    T* out_px = out + (img + (long long)y * W + x) * D;

    for (int dyi = dy_lo; dyi < dy_hi; ++dyi) {
        const int yy = y - max_disp + dyi * stride;
        float acc[JPT];
#pragma unroll
        for (int k = 0; k < JPT; ++k) acc[k] = 0.f;

        if (yy >= 0 && yy < H) {                // uniform across the block
            for (int c0 = 0; c0 < C; c0 += CK) {
                __syncthreads();                // last pass done reading smem
                for (int i = threadIdx.x; i < TX * CK; i += blockDim.x) {
                    const int p = i / CK, c = i % CK;
                    const int xa = x0 + p;
                    float v = 0.f;
                    if (xa < W && c0 + c < C)
                        v = to_f32(a[(img + (long long)y * W + xa) * C + c0 + c]);
                    a_s[c * a_pitch + p] = v;
                }
                for (int i = threadIdx.x; i < seg * CK; i += blockDim.x) {
                    const int p = i / CK, c = i % CK;
                    const int xb = x0 - max_disp + p;
                    float v = 0.f;
                    if (xb >= 0 && xb < W && c0 + c < C)
                        v = to_f32(b[(img + (long long)yy * W + xb) * C + c0 + c]);
                    b_s[c * b_pitch + p] = v;
                }
                __syncthreads();
                const int cn = min(CK, C - c0);
                for (int c = 0; c < cn; ++c) {
                    const float av = a_s[c * a_pitch + lane];
                    const float* brow = b_s + c * b_pitch + lane;
#pragma unroll
                    for (int k = 0; k < JPT; ++k) {
                        const int j = warp + k * NWARP;
                        if (j < n_disp) acc[k] = fmaf(av, brow[j * stride], acc[k]);
                    }
                }
            }
        }
        if (x < W) {
#pragma unroll
            for (int k = 0; k < JPT; ++k) {
                const int j = warp + k * NWARP;
                if (j < n_disp) store(out_px + dyi * n_disp + j, acc[k] / (float)C);
            }
        }
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); never synchronises.
extern "C" int vv_correlation_fwd(const void* a, const void* b, void* out,
                                  int dtype, int B, int H, int W, int C,
                                  int max_disp, int stride, void* stream)
{
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || max_disp < 0 || stride <= 0)
        return (int)cudaErrorInvalidValue;
    const int n_disp = 2 * max_disp / stride + 1;
    const int n_groups = (n_disp + DY_PER_BLOCK - 1) / DY_PER_BLOCK;
    const size_t smem =
        sizeof(float) * CK * ((TX + 1) + (TX + 2 * max_disp + 1));
    if (n_disp > NWARP * JPT || smem > 48 * 1024 || H > 65535 ||
        (long long)B * n_groups > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((W + TX - 1) / TX, H, B * n_groups);
    const dim3 block(TX * NWARP);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        corr_fwd_kernel<float><<<grid, block, smem, s>>>(
            (const float*)a, (const float*)b, (float*)out, H, W, C, max_disp,
            stride, n_disp, n_groups);
    } else if (dtype == 1) {
        corr_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
            (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
            (__nv_bfloat16*)out, H, W, C, max_disp, stride, n_disp, n_groups);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
