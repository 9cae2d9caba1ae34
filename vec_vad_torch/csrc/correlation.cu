// FlowNetC correlation forward (K1), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel vec_vad_tpu/models/flownet/ops.py:73-155
// (`_corr_kernel` / `correlation_pallas`, pl.pallas_call at :133).
// Computes exactly what `correlation_ref` computes
// (vec_vad_torch/models/flownet/ops.py):
//
//   out[b, y, x, i*n + j] = (1/C) * sum_c a[b, y, x, c] * b[b, y + dy_i, x + dx_j, c]
//   dy_i = -max_disp + i*stride, dx_j = -max_disp + j*stride, n = 2*max_disp/stride + 1
//
// with b zero outside the frame, the displacement channel dy-major (the
// reference CUDA kernel's top_channel order), the channel dot accumulated
// in f32 and the result stored in the input dtype (f32 or bf16), rounded
// once from the f32 sum. NHWC in, NHWC out, all tensors contiguous.
//
// Bound (in-frame multiply-adds at the 67 TFLOP/s f32 CUDA-core peak; the
// dot has no tensor-core form in f32; bytes at 3.35 TB/s):
//   serving  (1, 48, 64, 256), n = 21: 0.45 GFLOP -> 6.8 us; 2 x 3.1 MB
//            in + 5.4 MB out -> 3.5 us. Bound by operations.
//   training (8, 48, 64, 256): 3.6 GFLOP -> 54 us; 94 MB -> 28 us.
// So the multiply-adds have to be fed from registers: shared memory serves
// 128 bytes a clock to an SM's 128 FMA lanes, one float per FMA at most.
//
// The first design (`corr_fwd_kernel`, kept for every other grid) ran at
// 32x / 19x that bound: 3 accumulators a thread, so about 4 shared-memory
// loads for 3 FMAs; the a-tile restaged behind two barriers for each of a
// block's 7 displacement rows; outputs stored one float a lane, 1764
// bytes apart; the displacement bounds tested at run time in the inner
// loop.
//
// FlowNetC's grid (max_disp 20, stride 2, C a multiple of 4, 16-byte
// aligned a and b in f32, 8-byte in bf16) takes `corr_fwd_win_kernel`:
//   * a sliding window in registers. At stride 2, pixel x + 2k at
//     displacement j reads the b pixel that pixel x reads at j + k. A
//     thread owns P = 8 consecutive pixels of one residue of x mod 2 and
//     J = 7 consecutive displacements j of one displacement row, keeps
//     acc[P][J] in f32 registers over all C channels, and per 4-channel
//     quad loads P a-vectors and P + J - 1 = 14 b-vectors (16-byte
//     shared-memory loads) for P*J*4 = 224 FMAs: 10 FMAs a load;
//   * a block: one batch item, one output row y, a 64-pixel x-tile and a
//     group of DYB = 4 displacement rows (6 groups for n = 21: 288 blocks
//     at the serving shape, 56 of them wholly outside the frame). 3 warps,
//     one per group of J displacements; lane = (row, residue, pixel
//     group), so the 8 lanes of a quarter-warp read 8 distinct a-vectors
//     that lie in 8 distinct bank groups, and likewise the b-vectors (one
//     pad per 8 window positions and a quad pitch of 1 mod 8 vectors);
//   * the a-row is staged once per (block, 16-channel slice) and serves
//     all of the block's displacement rows: it is never restaged per row.
//     Channel slices, not the whole row, stay resident, so the block's
//     shared memory is 35 KB of static memory; registers (acc[P][J], P
//     a-vectors) allow four blocks an SM, 12 warps;
//   * the b rows are staged per (displacement row, channel slice), zero
//     outside the frame; a group of rows wholly outside the frame reads
//     nothing and writes zeros. Staging is by cp.async (bf16 widened to
//     f32 in place after the wait), so a thread's copies are all in flight
//     at once, behind one barrier a slice; plain loads kept each copy's
//     latency in series and ran 11 % slower at the training shape;
//   * stores coalesced: the outputs are staged in shared memory, then each
//     pixel's contiguous run of rows x 21 values (channels i*21 + j of the
//     block's rows) is written by consecutive lanes to consecutive
//     addresses.
// What holds it now (PERF.md §6): a block waits on each slice's copies
// with nothing else to do, and 12 warps an SM do not hide that nor the
// shared-memory load latency; double-buffered copies and blocks of several
// output rows sharing staged b rows are the next levers.
// Every other grid, an odd C or a misaligned pointer takes the general
// kernel `corr_fwd_kernel`: one block per (batch item, output row y, 32-pixel
// x-tile, group of 7 displacement rows), a and b staged per displacement
// row and 32-channel slice, lane = output pixel, 3 accumulators a thread.
// Limits (checked here and by the Python wrapper): n <= 24, 48 KB of
// shared memory (max_disp <= 148), H <= 65535 and B * (row groups) <=
// 65535 (6 groups on FlowNetC's grid, ceil(n / 7) on the others).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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


// ---------------------------------------------------------------------------
// FlowNetC's grid: max_disp 20, stride 2, C % 4 == 0
// ---------------------------------------------------------------------------

namespace win {
constexpr int MD = 20, ST = 2;
constexpr int N = 2 * MD / ST + 1;      // 21 displacements a row
constexpr int P = 8;                    // consecutive pixels of one residue a thread
constexpr int J = 7;                    // consecutive displacements j a thread
constexpr int NJG = N / J;              // 3 groups of j: one warp each
constexpr int NMG = 4;                  // groups of P pixels a residue
constexpr int TXW = ST * NMG * P;       // 64 output pixels a block
constexpr int DYB = 4;                  // displacement rows a block (lanes)
constexpr int NG = (N + DYB - 1) / DYB; // 6 groups of rows
constexpr int CS = 16;                  // channels staged a pass
constexpr int CQ = CS / 4;              // channel quads a pass
constexpr int NPOS = NMG * P + N - 1;   // 52 window positions a residue
constexpr int RP = 60;                  // a residue's positions, one pad per 8 (4 mod 8)
constexpr int QS = ST * RP + 1;         // vectors of a row's quad (1 mod 8)
constexpr int AQS = TXW + 1;            // vectors of the a-tile's quad (1 mod 8)
constexpr int OP = 87;                  // floats a staged output pixel (<= 2-way conflicts)
constexpr int NT = 32 * NJG;            // threads a block
constexpr int MINB = 4;                 // blocks an SM: 5 hold a thread to 128 registers, and spill
static_assert(NJG * J == N && ST * RP + 1 == QS && NPOS - 1 + (NPOS - 1) / 8 < RP, "tile");
static_assert(TXW * OP <= DYB * CQ * QS * 4, "outputs fit in the b tile");
}  // namespace win

// One 4-channel vector of a or b into its f32 slot in shared memory by
// cp.async, zero where !ok (`src` is then any readable address and is not
// read), so all of a thread's copies are in flight at once. bf16 lands in
// the slot's upper 8 bytes and is widened in place by the same thread
// after the wait (`widen`).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void stage4(float4* dst, const float* src, bool ok)
{
    cp_async<16>(dst, src, ok);
}

__device__ __forceinline__ void stage4(float4* dst, const __nv_bfloat16* src, bool ok)
{
    cp_async<8>(reinterpret_cast<char*>(dst) + 8, src, ok);
}

__device__ __forceinline__ void widen(float4* v)
{
    const uint2 u = *reinterpret_cast<const uint2*>(reinterpret_cast<const char*>(v) + 8);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    *v = make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float dot4(float4 u, float4 v, float acc)
{
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
    acc = fmaf(u.z, v.z, acc);
    return fmaf(u.w, v.w, acc);
}

// grid: x = 64-pixel x-tile, y = output row, z = (batch item, group of DYB
// displacement rows). Warp jg owns displacements j = J*jg .. J*jg + J - 1;
// lane = (row dyl, residue r, pixel group mg) owns pixels x0 + r + 2m,
// m = P*mg .. P*mg + P - 1, of displacement row i0 + dyl.
template <typename T>
__global__ void __launch_bounds__(win::NT, win::MINB)
corr_fwd_win_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, int H, int W, int C)
{
    using namespace win;
    __shared__ float4 A_s[CQ * AQS];        // [quad][k][residue][pixel group]
    __shared__ float4 B_s[DYB * CQ * QS];   // [row][quad][residue][position + pad]

    const int tid = threadIdx.x;
    const int jg = tid >> 5, lane = tid & 31;
    const int dyl = lane >> 3, r = (lane >> 2) & 1, mg = lane & 3;
    const int x0 = blockIdx.x * TXW, y = blockIdx.y;
    const int bi = blockIdx.z / NG, i0 = blockIdx.z % NG * DYB;
    const int rows = min(DYB, N - i0);
    const long long img = (long long)bi * H * W;
    const int D = N * N;
    const int run = rows * N;                   // a pixel's outputs in this block
    const int npx = min(TXW, W - x0);
    auto out_row = [&]() { return out + (img + (long long)y * W + x0) * D + i0 * N; };
    // staged vector e: a's (quad, pixel px of the tile), b's (row, quad,
    // pixel px of the haloed row)
    constexpr int NA = (CQ * TXW + NT - 1) / NT, NB = (DYB * ST * NPOS * CQ + NT - 1) / NT;
    auto a_slot = [&](int e) {
        const int cq = e % CQ, px = e / CQ, m = px >> 1;
        return A_s + cq * AQS + (m % P) * 8 + (px & 1) * 4 + m / P;
    };
    auto b_slot = [&](int e) {
        const int cq = e % CQ, px = e / CQ % (ST * NPOS), dl = e / (CQ * ST * NPOS);
        const int p = px >> 1;
        return B_s + (dl * CQ + cq) * QS + (px & 1) * RP + p + (p >> 3);
    };

    // rows i0 + dl lie in the frame for dl in [dl_lo, dl_hi)
    const int dl_lo = max(0, (MD - y + ST - 1) / ST - i0);
    const int dl_hi = min(rows, (H - 1 - y + MD) / ST + 1 - i0);
    if (dl_lo >= dl_hi) {                       // uniform across the block
        for (int e = tid; e < npx * run; e += NT)
            store(out_row() + (long long)(e / run) * D + e % run, 0.f);
        return;
    }

    float acc[P][J];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
        for (int jj = 0; jj < J; ++jj) acc[k][jj] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CS) {
        __syncthreads();                        // the last pass is done reading
#pragma unroll
        for (int u = 0; u < NA; ++u) {
            const int e = tid + u * NT;
            const int cq = e % CQ, px = e / CQ;
            const int x = x0 + px, c = c0 + 4 * cq;
            const bool ok = x < W && c < C;
            if (e < CQ * TXW)
                stage4(a_slot(e), ok ? a + (img + (long long)y * W + x) * C + c : a, ok);
        }
        // rolled: cp.async needs no registers to keep every copy in
        // flight, and the accumulators keep theirs (no spills)
#pragma unroll 1
        for (int u = 0; u < NB; ++u) {
            const int e = tid + u * NT;
            const int cq = e % CQ, px = e / CQ % (ST * NPOS), dl = e / (CQ * ST * NPOS);
            const int c = c0 + 4 * cq;
            const int yy = y - MD + ST * (i0 + dl), xb = x0 - MD + px;
            const bool ok = dl >= dl_lo && dl < dl_hi && xb >= 0 && xb < W && c < C;
            if (e < DYB * ST * NPOS * CQ)
                stage4(b_slot(e), ok ? b + (img + (long long)yy * W + xb) * C + c : b, ok);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        if constexpr (sizeof(T) == 2) {         // bf16: widen this thread's own slots
#pragma unroll
            for (int u = 0; u < NA; ++u)
                if (tid + u * NT < CQ * TXW) widen(a_slot(tid + u * NT));
#pragma unroll 1
            for (int u = 0; u < NB; ++u)
                if (tid + u * NT < DYB * ST * NPOS * CQ) widen(b_slot(tid + u * NT));
        }
        __syncthreads();

#pragma unroll 1
        for (int cq = 0; cq < CQ; ++cq) {
            float4 av[P];
#pragma unroll
            for (int k = 0; k < P; ++k) av[k] = A_s[cq * AQS + k * 8 + r * 4 + mg];
            // window position t is b position P*mg + J*jg + t of residue r
            const float4* bp = B_s + (dyl * CQ + cq) * QS + r * RP;
            const int p0 = P * mg + J * jg;
#pragma unroll
            for (int t = 0; t < P + J - 1; ++t) {
                const int p = p0 + t;
                const float4 bv = bp[p + (p >> 3)];
#pragma unroll
                for (int k = 0; k < P; ++k) {
                    const int jj = t - k;
                    if (jj >= 0 && jj < J) acc[k][jj] = dot4(av[k], bv, acc[k][jj]);
                }
            }
        }
    }

    // outputs through shared memory: O[pixel][dl * N + j], then each
    // pixel's run of `run` values by consecutive lanes
    __syncthreads();
    float* O = reinterpret_cast<float*>(B_s);
    const float cf = (float)C;
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
            O[(r + ST * (P * mg + k)) * OP + dyl * N + J * jg + jj] = acc[k][jj] / cf;
    __syncthreads();
    T* const orow = out_row();
    for (int e = tid; e < npx * run; e += NT) {
        const int xl = e / run, q = e % run;
        store(orow + (long long)xl * D + q, O[xl * OP + q]);
    }
}

bool aligned(const void* p, size_t bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); never synchronises.
extern "C" int vv_correlation_fwd(const void* a, const void* b, void* out,
                                  int dtype, int B, int H, int W, int C,
                                  int max_disp, int stride, void* stream)
{
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || max_disp < 0 || stride <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t vec_bytes = dtype == 0 ? 16 : 8;     // 4 channels
    if (max_disp == win::MD && stride == win::ST && C % 4 == 0 && (dtype == 0 || dtype == 1) &&
        aligned(a, vec_bytes) && aligned(b, vec_bytes)) {
        if (H > 65535 || (long long)B * win::NG > 65535) return (int)cudaErrorInvalidValue;
        const dim3 grid((W + win::TXW - 1) / win::TXW, H, B * win::NG);
        if (dtype == 0)
            corr_fwd_win_kernel<float><<<grid, win::NT, 0, s>>>(
                (const float*)a, (const float*)b, (float*)out, H, W, C);
        else
            corr_fwd_win_kernel<__nv_bfloat16><<<grid, win::NT, 0, s>>>(
                (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)out, H, W, C);
        return (int)cudaGetLastError();
    }
    const int n_disp = 2 * max_disp / stride + 1;
    const int n_groups = (n_disp + DY_PER_BLOCK - 1) / DY_PER_BLOCK;
    const size_t smem =
        sizeof(float) * CK * ((TX + 1) + (TX + 2 * max_disp + 1));
    if (n_disp > NWARP * JPT || smem > 48 * 1024 || H > 65535 ||
        (long long)B * n_groups > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((W + TX - 1) / TX, H, B * n_groups);
    const dim3 block(TX * NWARP);
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
