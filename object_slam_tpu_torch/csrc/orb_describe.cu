// ORB describe for a whole frame on Hopper (sm_90a): the IC angle and the
// 256-bit steered-BRIEF descriptor of every keypoint of every pyramid
// level, in one launch.
//
// Replaces: object_slam_tpu/ops/patch_pallas.py:74 (extract_patches, the
// Pallas kernel _patch_kernel) together with what consumes its two patch
// tensors per level in object_slam_tpu/features/extractor.py: the IC-angle
// moments (_ic_angle_from_patches), the level's Gaussian blur
// (features/pyramid.py::gaussian_blur) and steered BRIEF
// (_brief_from_patches). Plain version: ops/describe.py::orb_describe_ref.
//
// Bound on the H100 SXM (3.35 TB/s): bytes. At TUM VGA a frame has 1024
// keypoints over 8 levels. The kernel must read the raw pixels their
// 38x38 windows touch (at most the whole 3.6 MiB pyramid), the BRIEF table
// rows of the bins in use (at most 64 KiB) and 12 bytes of corner and
// level per keypoint, and write 36 bytes per keypoint: about 1 us. The
// arithmetic (~35 MFLOP) is negligible.
//
// Design: one block of 256 threads per keypoint, all levels in one launch
// (the level table rides in the by-value parameter block), so a frame pays
// one launch and one set of wrapper checks instead of sixteen, and no patch
// or blurred pixel reaches device memory (the per-level path writes and
// reads back 2048 patches of 4 KiB and a blurred copy of every level).
//  1. The block clamps its corner as extract_patches does and stages the
//     38x38 raw window (the 32x32 patch plus the blur's 3-pixel halo) in
//     shared memory with cp.async. Halo pixels wrap modulo H and W: the
//     reference's blur wraps (torch.roll) and a clamped window at the
//     border reaches past it. Not TMA: six of the eight TUM-VGA level
//     widths (533, 370, 309, 257, 214, 179) give row strides that are not
//     multiples of 16 bytes, which a TMA tensor map refuses, and TMA does
//     not wrap.
//  2. The circular-mask moments m10, m01 and the mass of the central
//     32x32, summed in double (warp shuffles, then shared memory); one
//     thread takes atan2f, the stability gate and the rotation bin.
//  3. The blur: a horizontal pass over 38 rows x 32 columns, then a
//     vertical pass over 32x32, in shared memory, in the plain version's
//     tap order (tap i adds w_i * img[x - 3 + i], i = 0..6) with separate
//     roundings: __fmul_rn / __fadd_rn keep nvcc from contracting the pair
//     into an FMA, which would move a blurred value by an ulp and flip bf16
//     roundings and BRIEF bits. Then round to bf16, to nearest even, as
//     .to(torch.bfloat16) does.
//  4. Steered BRIEF: thread j compares the two samples of bit j in the
//     keypoint's bin; one __ballot_sync per warp is descriptor word w
//     (lane k = bit 32w + k). The index tables stay int16 in global memory
//     (64 KiB, resident in L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kPatch = 32;
constexpr int kHalf = 15;
constexpr int kBlurR = 3;
constexpr int kTaps = 2 * kBlurR + 1;
constexpr int kWin = kPatch + 2 * kBlurR;  // 38
constexpr int kBits = 256;
constexpr int kBins = 64;
constexpr int kThreads = kBits;            // thread j computes bit j
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.28318530717958647692f;

}  // namespace

// The by-value parameter block; ops/describe.py::_Params mirrors it field
// for field.
struct OrbParams {
  const float* img[kMaxLevels];  // [h, w] f32 row-major level images
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n_levels;
  float blur[kTaps];             // gaussian_blur's taps
  int radius;                    // IC-angle mask radius
  float tau;                     // IC-angle stability gate
};

namespace {

__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// v in [-n, 2n) -> v mod n
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    orb_describe_kernel(const OrbParams p, const int* __restrict__ cy,
                        const int* __restrict__ cx,
                        const int* __restrict__ lvl,
                        const int16_t* __restrict__ idx1,
                        const int16_t* __restrict__ idx2,
                        float* __restrict__ angle, int* __restrict__ desc) {
  __shared__ float raw[kWin][kWin];          // raw window, wrapped halo
  __shared__ float hor[kWin][kPatch];        // horizontal blur pass
  __shared__ float blurred[kPatch * kPatch]; // blurred, rounded to bf16
  __shared__ double part[3][kWarps];         // per-warp moment sums
  __shared__ int bin_s;

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int l = lvl[k];
  if (l < 0 || l >= p.n_levels) {  // outside the level table: NaN angle
    if (t < 8) desc[k * 8 + t] = 0;
    if (t == 0) angle[k] = __int_as_float(0x7fc00000);
    return;
  }
  const int H = p.h[l];
  const int W = p.w[l];
  const float* img = p.img[l];
  const int y0 = min(max(cy[k], 0), H - kPatch);
  const int x0 = min(max(cx[k], 0), W - kPatch);

  // 1. stage the raw window
  for (int i = t; i < kWin * kWin; i += kThreads) {
    const int r = i / kWin;
    const int c = i - r * kWin;
    const int gy = wrap(y0 - kBlurR + r, H);
    const int gx = wrap(x0 - kBlurR + c, W);
    cp_async_f32(&raw[r][c], img + static_cast<size_t>(gy) * W + gx);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. IC moments over the central 32x32 (the unwrapped patch)
  double m10 = 0.0, m01 = 0.0, mass = 0.0;
  const int r2 = p.radius * p.radius;
  for (int i = t; i < kPatch * kPatch; i += kThreads) {
    const int dy = (i >> 5) - kHalf;
    const int dx = (i & 31) - kHalf;
    if (dy * dy + dx * dx <= r2) {
      const double v = raw[(i >> 5) + kBlurR][(i & 31) + kBlurR];
      m10 += v * dx;
      m01 += v * dy;
      mass += fabs(v);
    }
  }
  // 3a. horizontal blur pass over every window row
  for (int i = t; i < kWin * kPatch; i += kThreads) {
    const int r = i >> 5;
    const int c = i & 31;
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kTaps; ++q)
      acc = __fadd_rn(acc, __fmul_rn(p.blur[q], raw[r][c + q]));
    hor[r][c] = acc;
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  mass = warp_sum(mass);
  if (lane == 0) {
    part[0][warp] = m10;
    part[1][warp] = m01;
    part[2][warp] = mass;
  }
  __syncthreads();

  // 3b. vertical blur pass, rounded to bf16
  for (int i = t; i < kPatch * kPatch; i += kThreads) {
    const int r = i >> 5;
    const int c = i & 31;
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kTaps; ++q)
      acc = __fadd_rn(acc, __fmul_rn(p.blur[q], hor[r + q][c]));
    blurred[i] = __bfloat162float(__float2bfloat16_rn(acc));
  }
  // the angle, its stability gate and its rotation bin, in the plain
  // version's float32 operations
  if (t == 0) {
    double s10 = 0.0, s01 = 0.0, sm = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      s10 += part[0][w];
      s01 += part[1][w];
      sm += part[2][w];
    }
    const float f10 = static_cast<float>(s10);
    const float f01 = static_cast<float>(s01);
    const float fmass = __fmul_rn(static_cast<float>(sm),
                                  static_cast<float>(p.radius));
    const float mag = __fsqrt_rn(
        __fadd_rn(__fmul_rn(f10, f10), __fmul_rn(f01, f01)));
    const float a = mag > __fmul_rn(p.tau, fmass) ? atan2f(f01, f10) : 0.0f;
    angle[k] = a;
    const int b = __float2int_rn(
        __fmul_rn(__fdiv_rn(a, kTwoPi), static_cast<float>(kBins)));
    bin_s = b & (kBins - 1);  // remainder mod 64, also for b < 0
  }
  __syncthreads();

  // 4. steered BRIEF: bit t of the keypoint's bin
  const int b = bin_s;
  const float s1 = blurred[idx1[b * kBits + t]];
  const float s2 = blurred[idx2[b * kBits + t]];
  const unsigned word = __ballot_sync(0xffffffffu, s2 > s1);
  if (lane == 0) desc[k * 8 + warp] = static_cast<int>(word);
}

}  // namespace

// params: host pointer to the level table and settings; cy, cx, lvl: [n]
// int32 window corners and level slots; idx1, idx2: [64, 256] int16 flat
// patch indices; angle: [n] f32; desc: [n, 8] int32. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int orb_describe(const OrbParams* params, const int* cy,
                            const int* cx, const int* lvl, int n,
                            const int16_t* idx1, const int16_t* idx2,
                            float* angle, int* desc, void* stream) {
  if (n > 0) {
    orb_describe_kernel<<<n, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        *params, cy, cx, lvl, idx1, idx2, angle, desc);
  }
  return static_cast<int>(cudaGetLastError());
}
