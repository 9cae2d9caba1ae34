// Greedy NMS's scan over a precomputed suppression mask, one row of
// candidates a thread block (fore/mmdet_detector.py::greedy_keep on the
// card).
//
// Row r holds K candidates in score order, valid[r][j], and the mask
// over[r][i][j] (IoU above the threshold). Candidate j is kept when it is
// valid and no kept candidate i < j has over[r][i][j]: the block walks the
// candidates in order, and each kept one marks the later candidates it
// suppresses in a shared flag array before the next is looked at. The
// walk stops after the row's last valid candidate, and a suppressed or
// invalid candidate costs one shared-memory read, so a row's time is set
// by its valid candidates and its kept ones, never by how long a chain of
// suppressions runs (the fixed-point sweep it replaces on the card took
// one pass over every row per link of the longest chain).
//
// C interface: vv_nms_scan(over, valid, keep, R, K, stream), over a
// uint8 (R, K, K), valid and keep uint8 (R, K), all contiguous on the
// device; returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) nms_scan_kernel(const uint8_t* __restrict__ over,
                                                      const uint8_t* __restrict__ valid,
                                                      uint8_t* __restrict__ keep, int K)
{
    extern __shared__ uint8_t dead[];  // invalid, or suppressed by a kept candidate
    __shared__ int last;               // the row's last valid candidate
    const size_t r = blockIdx.x;
    const uint8_t* va = valid + r * K;
    uint8_t* ke = keep + r * K;
    if (threadIdx.x == 0) last = -1;
    __syncthreads();
    int mine = -1;
    for (int j = threadIdx.x; j < K; j += NT) {
        const uint8_t v = va[j];
        dead[j] = !v;
        ke[j] = 0;
        if (v) mine = j;
    }
    atomicMax(&last, mine);
    __syncthreads();
    const int n = last + 1;
    const uint8_t* rows = over + r * (size_t)K * K;
    for (int i = 0; i < n; ++i) {
        // every write to dead[] so far came before a barrier all threads
        // passed, so the branch is the same for the whole block
        if (!dead[i]) {
            if (threadIdx.x == 0) ke[i] = 1;
            const uint8_t* row = rows + (size_t)i * K;
            for (int j = i + 1 + threadIdx.x; j < n; j += NT)
                if (row[j]) dead[j] = 1;
            __syncthreads();
        }
    }
}

}  // namespace

extern "C" int vv_nms_scan(const void* over, const void* valid, void* keep, int R, int K,
                           void* stream)
{
    if (R < 0 || K <= 0 || K > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (R == 0) return (int)cudaSuccess;
    nms_scan_kernel<<<R, NT, K, (cudaStream_t)stream>>>(
        (const uint8_t*)over, (const uint8_t*)valid, (uint8_t*)keep, K);
    return (int)cudaGetLastError();
}
