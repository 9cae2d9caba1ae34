// FlowNetC correlation backward (K2), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel vec_vad_tpu/models/flownet/ops.py:197-314
// (`_corr_bwd_kernel` / `correlation_bwd_pallas`, pl.pallas_call at :275).
// Computes exactly what `correlation_bwd_ref` computes
// (vec_vad_torch/models/flownet/ops.py):
//
//   grad_a[b, y, x, c] = (1/C) * sum_{i,j} g[b, y, x, i*n + j]             * b[b, y + dy_i, x + dx_j, c]
//   grad_b[b, y, x, c] = (1/C) * sum_{i,j} g[b, y - dy_i, x - dx_j, i*n + j] * a[b, y - dy_i, x - dx_j, c]
//   dy_i = -max_disp + i*stride, dx_j = -max_disp + j*stride, n = 2*max_disp/stride + 1
//
// with every operand zero outside the frame, no recompute of the forward,
// f32 accumulation and the grads stored in the input dtype (f32 or bf16).
// NHWC in, NHWC out, all tensors contiguous.
//
// Bound at the training shape (8, 48, 64, 256) f32, n = 21 (D = 441):
//   operations: the in-frame products of both grads, 2 * 2 * 8*788*1124*256
//               = 7.3 GFLOP -> 0.108 ms at the 67 TFLOP/s f32 CUDA-core peak;
//   bytes:      g (43 MB), a and b (25 MB each) read, two grads (25 MB each)
//               written = 144 MB -> 0.043 ms at 3.35 TB/s.
// So it is bound by operations: the multiply-adds have to be fed from
// registers, not from one memory load each.
//
// The first design (one lane per pixel, 4 channels a lane, one block per
// output row, 32-pixel tile and 32-channel slice) ran at 24.6x that bound:
// one shared-memory load per FMA (shared memory serves a quarter of the FMA
// rate), 128 registers a thread (16 of an SM's 64 warps), the source row
// and the cotangents restaged behind two barriers by each of 8
// channel-slice blocks per output row, and grad_b's cotangents gathered one
// float per 1764-byte pixel.
//
// This design:
//   * gather form, as before: each output element is summed by one thread
//     over all n*n displacements, i-major and j-minor, and written once (no
//     atomics, no second pass), so the plain version's sum order stands;
//   * a sliding window in registers. Pixel x + stride*k at displacement j
//     reads the source pixel that pixel x reads at j + k (grad_b: j - k).
//     So a thread owns P = 8 pixels spaced by the stride (a line: one
//     residue of x mod stride) and Q = 4 consecutive channels, keeps
//     acc[P][Q] in registers across all dy rows, and per displacement j
//     loads ONE new source vector of Q channels into a ring of P + 2 (two
//     loads ahead) and does P*Q = 32 FMAs on it;
//   * lanes along channels: lane l owns channels 4l..4l+3 of a 128-channel
//     group, so a window load is one 16-byte shared-memory load a lane
//     (8 bytes in bf16) with no bank conflict, and a line's P cotangents
//     are the same for all 32 lanes: two 16-byte broadcasts per j;
//   * the other operand staged in shared memory, once per (block, source
//     row), by cp.async, double-buffered: the next source row's tile and
//     cotangents are in flight while the block computes on this one, behind
//     one barrier per row. The tile holds, per residue, the LP + n - 1
//     source pixels its lines' windows slide over, CG channels each;
//   * blocks of YB = 2 output rows, y0 and y0 + stride, x 8 lines (at
//     stride 2: 2 residues x 4 lines = the 64-pixel row) x 128 channels,
//     16 warps. Output row y0 + stride meets each source row one dy index
//     after row y0, so one staged source row serves both: the tiles read
//     from L2 are n + 1 rows a block, not 2n;
//   * cotangents staged per (warp, source row) into [j][k], f32, in
//     contiguous runs: grad_a's pixel x_k pairs with its own n values (84
//     bytes at n = 21); grad_b's x_k at j pairs with pixel x_k - dx_j,
//     which depends on k - j only, so each of the P + n - 1 pixels gives a
//     run of up to P values (j = k - t), not one float per 1764-byte pixel;
//   * FlowNetC's displacements (max_disp 20, stride 2) have their own
//     instantiation, so the displacement loop's bounds and the tile's
//     shape are compile-time constants; other displacement grids take one
//     output row a block (8 warps, the registers their runtime bounds need).
//     Every instantiation runs without spills;
//   * C a multiple of 4 with 16-byte (f32) / 8-byte (bf16) aligned
//     pointers stages with vector copies and stores with vector stores;
//     any other C (33, say) takes the scalar instantiation of the same
//     kernel.
// Limits (checked here and by the Python wrapper): n <= 24, H and
// 2 * B <= 65535; shared memory then stays at most 172,032 bytes a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NLINE = 8;            // lines of P strided pixels per output row
constexpr int P = 8;                // pixels per thread, spaced by the stride
constexpr int Q = 4;                // consecutive channels per lane
constexpr int CG = 32 * Q;          // channels per block
constexpr int NBUF = 2;             // source rows staged in shared memory at once
constexpr int A = 2;                // window loads ahead of use
constexpr int RING = P + A;         // window registers per thread
constexpr int NMAX = 24;            // largest displacement grid side
constexpr int RB_MAX = 4;           // residues of x mod stride per block
constexpr int GP = P + 4;           // pitch of a staged cotangent row: 16-byte rows,
                                    // 8 banks apart for 8 consecutive j

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid)
{
    // zero-fills the destination where !valid (src is then not read)
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's newest commit groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// One cotangent into shared memory as f32: cp.async for f32, a load and a
// store for bf16. `any` is a readable address used where !valid.
__device__ __forceinline__ void stage_g(float* dst, const float* src, bool valid, const float* any)
{
    cp_async<4>(dst, valid ? src : any, valid);
}

__device__ __forceinline__ void stage_g(float* dst, const __nv_bfloat16* src, bool valid,
                                        const __nv_bfloat16*)
{
    *dst = valid ? __bfloat162float(*src) : 0.f;
}

// Channels [c, c + Q) of one source pixel into the tile, in the input
// dtype, zero where !in_frame or from C on. VEC: C % Q == 0 and aligned
// rows, so the Q channels are one cp.async (16 bytes f32, 8 bytes bf16).
template <bool VEC>
__device__ __forceinline__ void stage_q(float* dst, const float* src, int c, int C,
                                        bool in_frame, const float* any)
{
    if (VEC) {
        cp_async<16>(dst, in_frame && c < C ? src : any, in_frame && c < C);
        return;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
        cp_async<4>(dst + q, in_frame && c + q < C ? src + q : any, in_frame && c + q < C);
}

template <bool VEC>
__device__ __forceinline__ void stage_q(__nv_bfloat16* dst, const __nv_bfloat16* src, int c,
                                        int C, bool in_frame, const __nv_bfloat16* any)
{
    if (VEC) {
        cp_async<8>(dst, in_frame && c < C ? src : any, in_frame && c < C);
        return;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
        dst[q] = in_frame && c + q < C ? src[q] : __float2bfloat16(0.f);
}

// Q channels of the tile as f32 (16-byte / 8-byte shared-memory loads)
__device__ __forceinline__ float4 lds_q(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 lds_q(const __nv_bfloat16* p)
{
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <bool VEC>
__device__ __forceinline__ void store_q(float* p, float4 v, int c, int C)
{
    if (VEC) {
        if (c < C) *reinterpret_cast<float4*>(p) = v;
        return;
    }
    if (c < C) p[0] = v.x;
    if (c + 1 < C) p[1] = v.y;
    if (c + 2 < C) p[2] = v.z;
    if (c + 3 < C) p[3] = v.w;
}

template <bool VEC>
__device__ __forceinline__ void store_q(__nv_bfloat16* p, float4 v, int c, int C)
{
    if (VEC) {
        if (c >= C) return;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 u;
        u.x = *reinterpret_cast<const uint32_t*>(&lo);
        u.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p) = u;
        return;
    }
    if (c < C) p[0] = __float2bfloat16(v.x);
    if (c + 1 < C) p[1] = __float2bfloat16(v.y);
    if (c + 2 < C) p[2] = __float2bfloat16(v.z);
    if (c + 3 < C) p[3] = __float2bfloat16(v.w);
}

__device__ __forceinline__ void fma_q(float4& acc, float g, float4 v)
{
    acc.x = fmaf(g, v.x, acc.x);
    acc.y = fmaf(g, v.y, acc.y);
    acc.z = fmaf(g, v.z, acc.z);
    acc.w = fmaf(g, v.w, acc.w);
}

// The ring slot of window position t (any sign; t is a compile-time
// constant wherever the loops below are unrolled).
__host__ __device__ constexpr int slot(int t) { return ((t % RING) + RING) % RING; }

// The block's geometry for a stride: RB residues of x mod stride, LPR
// lines of P strided pixels each, so LP = LPR * P strided pixels per
// residue, and NPOS = LP + n - 1 source positions per residue.
struct Geometry {
    int rb, lpr, lp, npos;
    __host__ __device__ Geometry(int stride, int n_disp)
        : rb(stride < RB_MAX ? stride : RB_MAX), lpr(NLINE / rb), lp(lpr * P),
          npos(lpr * P + n_disp - 1) {}
};

// shared memory of one block: NBUF buffers, each one source row's tile
// (input dtype) and the cotangents (f32) of every output row it serves
__host__ __device__ inline size_t smem_bytes(int stride, int n_disp, int yb, size_t elem)
{
    const Geometry geo(stride, n_disp);
    return NBUF * (sizeof(float) * yb * NLINE * n_disp * GP + elem * geo.rb * geo.npos * CG);
}

// One block's grad: WRT_B computes grad_b from (a, g), else grad_a from
// (b, g); `src` is the other operand. The block covers output rows y0 +
// stride * ob (ob < YB), residues r0 .. r0 + RB - 1 of x mod stride,
// strided pixels q0*P .. q0*P + LP - 1 of each, and CG channels from cg0.
// Warp w: output row ob = w / NLINE, line w % NLINE = (residue rr, line
// qrel). Output row ob meets source row rho(u) at dy index i = u - ob
// (grad_b: u + ob), so one staged source row serves every output row.
template <typename T, bool VEC, int MD, int ST, int YB, bool WRT_B>
__device__ __forceinline__ void corr_bwd_block(
    const T* __restrict__ src, const T* __restrict__ g, T* __restrict__ out,
    unsigned char* smem, int H, int W, int C, int md_arg, int st_arg,
    int n_arg, int y0, long long img, int r0, int q0, int cg0)
{
    // ST > 0: max_disp and stride known at compile time
    const int max_disp = ST > 0 ? MD : md_arg;
    const int stride = ST > 0 ? ST : st_arg;
    const int n_disp = ST > 0 ? 2 * MD / ST + 1 : n_arg;
    const int D = n_disp * n_disp;
    const Geometry geo(stride, n_disp);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ob = warp / NLINE, line = warp % NLINE;
    const int rr = line / geo.lpr, qrel = line % geo.lpr;
    const int r = r0 + rr;
    const int m0 = (q0 + qrel) * P;             // this line's first strided pixel
    const int y = y0 + stride * ob;             // this warp's output row
    const int c_lane = cg0 + Q * lane;
    const int di = WRT_B ? ob : -ob;            // i = u + di
    // a warp whose row, residue or pixels lie outside has nothing to
    // compute (it still stages and meets the barriers)
    const bool active = y < H && rr < geo.rb && r < stride && r + stride * m0 < W;

    const int g_row = YB * NLINE * n_disp * GP;  // floats of one step's cotangents
    const int s_row = geo.rb * geo.npos * CG;   // elements of one source row's tile
    float* G = reinterpret_cast<float*>(smem);
    T* S = reinterpret_cast<T*>(smem + NBUF * sizeof(float) * g_row);

    // the source row of step u, and whether output row o uses it there
    auto rho = [&](int u) {
        return WRT_B ? y0 + max_disp - stride * u : y0 - max_disp + stride * u;
    };
    auto uses = [&](int u, int o) {
        const int i = u + (WRT_B ? o : -o);
        return y0 + stride * o < H && i >= 0 && i < n_disp;
    };

    // Stage step u into buffer buf. The tile: per residue er, source
    // positions p = 0 .. NPOS-1 at pixel xt + stride * p, one 512-byte (f32)
    // line of CG channels each, warps over positions and lanes over
    // channels. The cotangents: per (output row, line), G[j][k] =
    // g[y, x_k, i*n + j] (grad_a: lanes over j, one contiguous run of n a
    // pixel) or g[rho, x_k - dx_j, i*n + j] (grad_b: the pixel x_k - dx_j
    // depends on t = k - j only, so lanes over (t, k) read each pixel's
    // values j = k - t as one contiguous run of up to P).
    auto stage = [&](int u, int buf) {
        const int yy = rho(u);
        const T* srow = src + (img + (long long)yy * W) * C;
        T* Sb = S + buf * s_row;
        for (int er = 0; er < geo.rb; ++er) {
            const int xt = r0 + er + stride * q0 * P
                           + (WRT_B ? max_disp - stride * (n_disp - 1) : -max_disp);
            const bool res_ok = r0 + er < stride;
            for (int p = warp; p < geo.npos; p += YB * NLINE) {
                const int x = xt + stride * p;
                const bool ok = res_ok && (unsigned)x < (unsigned)W;
                stage_q<VEC>(Sb + (er * geo.npos + p) * CG + Q * lane,
                             ok ? srow + (long long)x * C + c_lane : src, c_lane, C, ok, src);
            }
        }
        if (active && uses(u, ob)) {
            const int i = u + di;
            const T* gi = g + (img + (long long)(WRT_B ? yy : y) * W) * D + i * n_disp;
            float* Gw = G + buf * g_row + warp * n_disp * GP;
            if (!WRT_B) {
                if (lane < n_disp) {
                    const int j = lane;
                    int x = r + stride * m0;
#pragma unroll
                    for (int k = 0; k < P; ++k, x += stride) {
                        const bool ok = x < W;
                        stage_g(Gw + j * GP + k, gi + (long long)(ok ? x : 0) * D + j, ok, g);
                    }
                }
            } else {
                for (int e = lane; e < (P + n_disp - 1) * P; e += 32) {
                    const int t = e / P - (n_disp - 1), k = e % P;
                    const int j = k - t;
                    if (j < 0 || j >= n_disp) continue;
                    const int x = r + max_disp + stride * (m0 + t);
                    const bool ok = (unsigned)x < (unsigned)W;
                    stage_g(Gw + j * GP + k, gi + (long long)(ok ? x : 0) * D + j, ok, g);
                }
            }
        }
        cp_commit();
    };

    float4 acc[P];
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

    // the steps whose source row lies in the frame and that some output
    // row uses are contiguous; the others add zero and are skipped
    int u_lo = n_disp + YB, u_hi = -YB;
    for (int u = 1 - YB; u < n_disp + YB - 1; ++u) {
        const int yy = rho(u);
        bool used = false;
        for (int o = 0; o < YB; ++o) used = used || uses(u, o);
        if (used && yy >= 0 && yy < H) {
            u_lo = min(u_lo, u);
            u_hi = u;
        }
    }
    // one commit group per step, empty past u_hi
    for (int k = 0; k < NBUF - 1; ++k) {
        if (u_lo + k <= u_hi) stage(u_lo + k, k);
        else cp_commit();
    }
    for (int u = u_lo; u <= u_hi; ++u) {
        const int buf = (u - u_lo) % NBUF;
        cp_wait<NBUF - 2>();
        __syncthreads();    // step u staged by every thread; step u - 1's buffer free
        const int un = u + NBUF - 1;
        if (un <= u_hi) stage(un, (un - u_lo) % NBUF);
        else cp_commit();
        if (!active || !uses(u, ob)) continue;

        // window position t (grad_a pairs (k, j) with t = k + j, grad_b
        // with t = k - j) is tile position qrel*P + t (grad_b: + n - 1)
        const float* Gr = G + buf * g_row + warp * n_disp * GP;
        const T* sp = S + buf * s_row
                      + (rr * geo.npos + qrel * P + (WRT_B ? n_disp - 1 : 0)) * CG + Q * lane;
        float4 win[RING];
        // positions used at j = 0 plus those needed A steps ahead
#pragma unroll
        for (int k = 0; k < RING - 1; ++k) {
            const int t = WRT_B ? P - 1 - k : k;
            win[slot(t)] = lds_q(sp + t * CG);
        }
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
            if (j < n_disp) {
                // the position step j + A brings in; its slot was last
                // read at step j - 1
                if (j + A < n_disp) {
                    const int t = WRT_B ? -(j + A) : j + A + P - 1;
                    win[slot(t)] = lds_q(sp + t * CG);
                }
#pragma unroll
                for (int k4 = 0; k4 < P; k4 += 4) {
                    const float4 gv = *reinterpret_cast<const float4*>(Gr + j * GP + k4);
                    const float gk[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
                    for (int k = k4; k < k4 + 4; ++k)
                        fma_q(acc[k], gk[k - k4], win[slot(WRT_B ? k - j : k + j)]);
                }
            }
        }
    }

    if (!active) return;
    const float cf = (float)C;
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const int x = r + stride * (m0 + k);
        if (x < W) {
            const float4 v = make_float4(acc[k].x / cf, acc[k].y / cf,
                                         acc[k].z / cf, acc[k].w / cf);
            store_q<VEC>(out + (img + (long long)y * W + x) * C + c_lane, v, c_lane, C);
        }
    }
}

// grid: x = (residue group, strided x-tile, channel group), channel group
// fastest; y = group of YB output rows y0, y0 + stride, ...; z = (batch
// item, grad). YB * NLINE warps.
template <typename T, bool VEC, int MD, int ST, int YB>
__global__ void __launch_bounds__(32 * YB * NLINE, 1)
corr_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ g, T* __restrict__ grad_a,
                T* __restrict__ grad_b, int H, int W, int C, int max_disp,
                int stride, int n_disp, int n_cg, int n_qt)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const Geometry geo(stride, n_disp);
    const int cg = blockIdx.x % n_cg;
    const int qt = (blockIdx.x / n_cg) % n_qt;
    const int rg = blockIdx.x / (n_cg * n_qt);
    const int y0 = blockIdx.y / stride * (YB * stride) + blockIdx.y % stride;
    const long long img = (long long)(blockIdx.z >> 1) * H * W;
    if (blockIdx.z & 1)
        corr_bwd_block<T, VEC, MD, ST, YB, true>(a, g, grad_b, smem, H, W, C, max_disp, stride,
                                                 n_disp, y0, img, rg * geo.rb, qt * geo.lpr,
                                                 cg * CG);
    else
        corr_bwd_block<T, VEC, MD, ST, YB, false>(b, g, grad_a, smem, H, W, C, max_disp, stride,
                                                  n_disp, y0, img, rg * geo.rb, qt * geo.lpr,
                                                  cg * CG);
}

constexpr size_t SMEM_MAX = 227 * 1024;     // a block's shared memory on sm_90

template <typename T>
int launch(const void* a, const void* b, const void* g, void* grad_a, void* grad_b,
           bool vec, int B, int H, int W, int C, int max_disp, int stride, int n_disp,
           cudaStream_t s)
{
    const Geometry geo(stride, n_disp);
    // FlowNetC's displacements (max_disp 20, stride 2) have their own
    // instantiation, with the loop bounds and the tile's shape known and
    // two output rows a block; other shapes take one row a block, whose
    // 256 threads may hold the registers their runtime bounds need
    const bool flownetc = vec && max_disp == 20 && stride == 2;
    const int yb = flownetc ? 2 : 1;
    const size_t smem = smem_bytes(stride, n_disp, yb, sizeof(T));
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const int n_rg = (stride + geo.rb - 1) / geo.rb;
    const int n_qt = ((W + stride - 1) / stride + geo.lp - 1) / geo.lp;
    const int n_cg = (C + CG - 1) / CG;
    const long long n_yg = (long long)stride * ((H + yb * stride - 1) / (yb * stride));
    if (n_yg > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(n_rg * n_qt * n_cg, (unsigned)n_yg, 2 * B);
    auto kernel = flownetc ? &corr_bwd_kernel<T, true, 20, 2, 2>
                  : vec ? &corr_bwd_kernel<T, true, 0, 0, 1> : &corr_bwd_kernel<T, false, 0, 0, 1>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, 32 * yb * NLINE, smem, s>>>(
        (const T*)a, (const T*)b, (const T*)g, (T*)grad_a, (T*)grad_b,
        H, W, C, max_disp, stride, n_disp, n_cg, n_qt);
    return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; a, b, g and both grads share it.
// One launch computes both grads. Returns the CUDA error of the launch (0
// on success); never synchronises.
extern "C" int vv_correlation_bwd(const void* a, const void* b, const void* g,
                                  void* grad_a, void* grad_b, int dtype,
                                  int B, int H, int W, int C, int max_disp,
                                  int stride, void* stream)
{
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || max_disp < 0 || stride <= 0)
        return (int)cudaErrorInvalidValue;
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    const int n_disp = 2 * max_disp / stride + 1;
    if (n_disp > NMAX || H > 65535 || 2LL * B > 65535)
        return (int)cudaErrorInvalidValue;
    const size_t vec_bytes = Q * (dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
    const bool vec = C % Q == 0 && aligned(a, vec_bytes) && aligned(b, vec_bytes) &&
                     aligned(grad_a, vec_bytes) && aligned(grad_b, vec_bytes);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch<float>(a, b, g, grad_a, grad_b, vec, B, H, W, C, max_disp, stride,
                             n_disp, s);
    return launch<__nv_bfloat16>(a, b, g, grad_a, grad_b, vec, B, H, W, C, max_disp,
                                 stride, n_disp, s);
}
