// Batched keypoint patch extraction for Hopper (sm_90a).
//
// Replaces: object_slam_tpu/ops/patch_pallas.py::extract_patches (the
// Pallas kernel _patch_kernel). Contract: extract_patches_xla in the same
// file — for N window corners (ys, xs), clamped to [0, H-32] x [0, W-32],
// out[n] = img[y:y+32, x:x+32]. A pure copy, so the result is bit-exact.
// The Pallas kernel's 8-row / 128-column aligned DMA superset, 8-way row
// select and one-hot column matmul work around TPU DMA tiling and are not
// part of the contract; they are not carried over.
//
// Design: one block per keypoint, 8 warps. The block clamps its own
// corner; each warp copies patch rows r = warp, warp+8, ...: lane c reads
// img[y+r, x+c] (32 consecutive floats, 128 bytes) and writes
// out[n, r, c] (128 contiguous bytes), so reads and writes are coalesced.
//
// Bound on the H100 SXM (3.35 TB/s): at TUM VGA a frame extracts 2048
// patches (two launches per pyramid level, 8 levels): 2048 x 4 KiB written
// plus the pixels the windows touch (at most as much again, less where
// windows overlap), at most 16 MiB, about 5 us per frame. Each launch moves
// only ~1 MiB, so launch latency, not bytes, dominates at 16 launches per
// frame. Later work: one launch for all levels, and fusing the IC-angle
// moments and the BRIEF bits so the patches never reach device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kThreads = 256;

__global__ void patch_extract_kernel(const float* __restrict__ img, int H,
                                     int W, const int* __restrict__ ys,
                                     const int* __restrict__ xs, int n,
                                     float* __restrict__ out) {
  const int k = blockIdx.x;
  if (k >= n) return;
  const int y0 = min(max(ys[k], 0), H - kPatch);
  const int x0 = min(max(xs[k], 0), W - kPatch);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* src = img + static_cast<size_t>(y0) * W + x0;
  float* dst = out + static_cast<size_t>(k) * kPatch * kPatch;
#pragma unroll
  for (int r = warp; r < kPatch; r += kThreads / 32) {
    dst[r * kPatch + lane] = src[static_cast<size_t>(r) * W + lane];
  }
}

}  // namespace

// img: [H, W] f32 (H, W >= 32); ys, xs: [n] int32 window corners;
// out: [n, 32, 32] f32. Launches on `stream` and returns cudaGetLastError().
extern "C" int patch_extract(const float* img, int H, int W, const int* ys,
                             const int* xs, int n, float* out, void* stream) {
  if (n > 0) {
    patch_extract_kernel<<<n, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        img, H, W, ys, xs, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
