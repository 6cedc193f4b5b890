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
// Two entries:
//  - patch_extract: one image, one block per window, 8 warps; each warp
//    copies patch rows r = warp, warp+8, ...: lane c reads img[y+r, x+c]
//    and writes out[n, r, c] (128 coalesced bytes each way).
//  - patch_extract_levels: the windows of every level of a pyramid in one
//    launch, the level table (16 entries, as orb_describe's) in the
//    by-value parameter block and a level slot per window. Thread t of a
//    window's block moves row t / 8, floats 4 (t % 8) .. 4 (t % 8) + 3:
//    one 16-byte load where that row segment is 16-byte aligned in the
//    level (the window is always inside the level after the clamp), four
//    4-byte loads where it is not (six of the eight TUM-VGA level widths
//    are not multiples of 4), and one 16-byte store.
//
// Bound on the H100 SXM (3.35 TB/s): bytes, every output window written
// once and every pixel the windows touch read once. The BRIEF-pattern
// learner's harvest calls it once per render with about 1,000 windows over
// 8 levels: about 6 MiB, 1.95 us. Measured on an H100, 8 per-level
// launches of patch_extract took 14.8-17.8 us on the device for one
// render, each launch too small to fill the card and each paying its own
// launch latency; one launch of patch_extract_levels pays it once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 32;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;

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

// The by-value level table; ops/patch.py::_Levels mirrors it.
struct PatchLevels {
  const float* img[kMaxLevels];  // [h, w] f32 row-major level images
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n_levels;
};

namespace {

__global__ void __launch_bounds__(kThreads)
    patch_extract_levels_kernel(const PatchLevels p,
                                const int* __restrict__ ys,
                                const int* __restrict__ xs,
                                const int* __restrict__ lvl, int n,
                                float4* __restrict__ out) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float4* dst = out + static_cast<size_t>(k) * (kPatch * kPatch / 4) + t;
  const int l = lvl[k];
  if (l < 0 || l >= p.n_levels) {    // outside the level table: zeros
    *dst = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int H = p.h[l];
  const int W = p.w[l];
  const int y0 = min(max(ys[k], 0), H - kPatch);
  const int x0 = min(max(xs[k], 0), W - kPatch);
  const float* src =
      p.img[l] + static_cast<size_t>(y0 + (t >> 3)) * W + x0 + 4 * (t & 7);
  float4 v;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    v = __ldg(reinterpret_cast<const float4*>(src));
  } else {
    v = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2),
                    __ldg(src + 3));
  }
  *dst = v;
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

// levels: host pointer to the level table (every level H, W >= 32); ys,
// xs, lvl: [n] int32 window corners and level slots; out: [n, 32, 32] f32
// (16-byte aligned); device: the CUDA device of every pointer. Launches on
// `stream` and returns cudaGetLastError() (or a runtime call's error).
extern "C" int patch_extract_levels(const PatchLevels* levels, const int* ys,
                                    const int* xs, const int* lvl, int n,
                                    float* out, int device, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    patch_extract_levels_kernel<<<n, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        *levels, ys, xs, lvl, n, reinterpret_cast<float4*>(out));
    err = cudaGetLastError();
  }
  if (prev >= 0 && prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
