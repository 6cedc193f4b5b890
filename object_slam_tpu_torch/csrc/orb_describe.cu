// ORB describe on Hopper (sm_90a): the IC angle and the 256-bit
// steered-BRIEF descriptor of every keypoint of every pyramid level of one
// image, or of a stereo pair's two images, in one launch.
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
// 38x38 windows touch (2.69 MiB on chip_smoke.py's frame), the BRIEF table
// rows of the bins in use and 12 bytes of corner and level per keypoint,
// and write 36 bytes per keypoint: 0.84 us. The arithmetic (36 MFLOP,
// 0.59 us at the f32 / f64 peaks) comes second.
//
// What held the first version (one block of 256 threads per keypoint,
// 9.84 us at TUM VGA on an H100, 11.7x the bound): at TUM VGA all 1,024
// blocks run in one wave, in step, so the kernel takes one block's chain
// of phases, each phase as long as the SM's issue of eight blocks' work
// in it. Knocking phases out of a first form of this design (build-time
// variants, H100, one call) splits its 9.3 us into: 1.43 us for a launch
// of 1,024 empty blocks; 2.5 us of staging (three dependent round trips:
// level, then corner, then window; the windows
// overlap, so the copies move 6.9 MB through L2 for 2.7 MiB of distinct
// pixels); 2.2 us for the moments and BRIEF; 3.1 us for the blur and the
// tail. The blur's rounding is the contract, so its 31.4k float32
// multiplies and adds per keypoint (about 1,000 warp instructions) stay.
//
// Design:
//  1. Persistent blocks of 256 threads, as many as fit on the card at
//     once (8 per SM), each walking keypoints k = block, block + grid, ...
//     with two window buffers: the next keypoint's window copies are
//     issued (cp.async, one commit group) before the current keypoint is
//     computed, and the corner and level of the one after are loaded (all
//     three together) one iteration ahead, so a window's latency hides
//     behind another's arithmetic where a block has more than one
//     keypoint (EuRoC, a KITTI pair's 4,096).
//  2. Staging: a window whose 38x38 halo lies inside the level (about 90%
//     of them) is copied as 16-byte cp.async chunks, 11 per row, each row
//     placed in shared memory at its own misalignment (0-3 floats): six of
//     the eight TUM-VGA level widths (533, 370, 309, 257, 214, 179) give
//     rows that are not 16-byte aligned, and a TMA tensor map refuses
//     such strides. 418 copies in place of 1,444 and no divide by 38 (a
//     constant divide by 11). A window whose halo leaves the level takes
//     the four-byte path with wraps: the reference's blur wraps
//     (torch.roll), and a clamped window at the border reaches past it.
//  3. The chain after staging: the circular-mask moments m10, m01 and the
//     mass of the central 32x32 in float32 per warp (shuffles), then one
//     warp sums the 8 warps' partials in double with shuffles and takes
//     atan2f, the stability gate and the rotation bin while the other
//     seven run the horizontal blur pass; the bin's BRIEF index loads (L2)
//     are issued before the vertical pass. Measured against the other
//     order (one warp computing the moments, the bin and the index
//     loads while seven warps ran both blur passes): 12.1 us, since the
//     one-warp moment chain became the critical path; not kept.
//  4. The blur, in the plain version's tap order (tap i adds
//     w_i * img[x - 3 + i], i = 0..6) with separate roundings:
//     __fmul_rn / __fadd_rn keep nvcc from contracting the pair into an
//     FMA, which would move a blurred value by an ulp and flip bf16
//     roundings and BRIEF bits. The horizontal pass makes two outputs per
//     thread from 8 shared loads, the vertical pass four from 10 (in
//     place of 7 per output). Then round to bf16, to nearest even, as
//     .to(torch.bfloat16) does.
//  5. Steered BRIEF: thread j compares the two samples of bit j in the
//     keypoint's bin; one __ballot_sync per warp is descriptor word w
//     (lane k = bit 32w + k).
// The level table (16 entries: a stereo pair's two pyramids) rides in the
// by-value parameter block, so a stereo pair takes one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kPatch = 32;
constexpr int kHalf = 15;
constexpr int kBlurR = 3;
constexpr int kTaps = 2 * kBlurR + 1;
constexpr int kWin = kPatch + 2 * kBlurR;  // 38
constexpr int kChunks = 11;                // 16-byte chunks per staged row
constexpr int kRow = 4 * kChunks;          // 44 floats: a row plus 0-3 lead
constexpr int kBits = 256;
constexpr int kBins = 64;
constexpr int kThreads = kBits;            // thread j computes bit j
constexpr int kWarps = kThreads / 32;
constexpr int kVRows = 4;                  // vertical pass: rows per thread
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

struct Slot {               // one staged window
  int level;                // -1: outside the level table
  int lead[kWin];           // row r's pixel c sits at raw[r][lead[r] + c]
};

struct Smem {
  float raw[2][kWin][kRow];           // two window buffers
  Slot slot[2];
  float hor[kWin][kPatch];            // horizontal blur pass
  float blurred[kPatch * kPatch];     // blurred, rounded to bf16
  double part[3][kWarps];             // per-warp moment sums
  int bin;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v in [-n, 2n) -> v mod n
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

struct Meta {               // one keypoint's level slot and corner
  int level, y, x;
};

// Keypoint k's level slot and corner: three independent loads, issued
// together; a block loads the next keypoint's one iteration ahead.
__device__ __forceinline__ Meta load_meta(int k, int n,
                                          const int* __restrict__ cy,
                                          const int* __restrict__ cx,
                                          const int* __restrict__ lvl) {
  Meta m{-1, 0, 0};
  if (k < n) {
    m.level = lvl[k];
    m.y = cy[k];
    m.x = cx[k];
  }
  return m;
}

// Issue a keypoint's window copies into buffer b (one commit group, also
// when empty, so that the group count stays in step).
__device__ void stage(const OrbParams& p, Smem& s, int b, const Meta& m) {
  const int t = threadIdx.x;
  const int l = m.level;
  if (l < 0 || l >= p.n_levels) {
    if (t == 0) s.slot[b].level = -1;
    cp_async_commit();
    return;
  }
  const int H = p.h[l];
  const int W = p.w[l];
  const float* img = p.img[l];
  const int y0 = min(max(m.y, 0), H - kPatch);
  const int x0 = min(max(m.x, 0), W - kPatch);
  if (t == 0) s.slot[b].level = l;
  // the window's first pixel of row r is element e_r = (y0-3+r) W + x0-3;
  // its 16-byte chunk starts at e_r & ~3, and 11 chunks cover the row
  const long long e_last =
      static_cast<long long>(y0 + kPatch + kBlurR - 1) * W + x0 - kBlurR;
  const bool inside =
      y0 >= kBlurR && y0 + kPatch + kBlurR <= H && x0 >= kBlurR &&
      x0 + kPatch + kBlurR <= W &&
      (reinterpret_cast<uintptr_t>(img) & 15) == 0 &&
      (e_last & ~3LL) + kRow <= static_cast<long long>(H) * W;
  if (inside) {
    for (int i = t; i < kWin * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const long long e =
          static_cast<long long>(y0 - kBlurR + r) * W + x0 - kBlurR;
      const long long e0 = e & ~3LL;
      cp_async16(&s.raw[b][r][4 * c], img + e0 + 4 * c);
      if (c == 0) s.slot[b].lead[r] = static_cast<int>(e - e0);
    }
  } else {
    for (int i = t; i < kWin * kWin; i += kThreads) {
      const int r = i / kWin;
      const int c = i - r * kWin;
      const int gy = wrap(y0 - kBlurR + r, H);
      const int gx = wrap(x0 - kBlurR + c, W);
      cp_async4(&s.raw[b][r][c], img + static_cast<size_t>(gy) * W + gx);
    }
    if (t < kWin) s.slot[b].lead[t] = 0;
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
    orb_describe_kernel(const OrbParams p, const int* __restrict__ cy,
                        const int* __restrict__ cx,
                        const int* __restrict__ lvl, int n,
                        const int16_t* __restrict__ idx1,
                        const int16_t* __restrict__ idx2,
                        float* __restrict__ angle, int* __restrict__ desc) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& s = *reinterpret_cast<Smem*>(smem_bytes);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r2 = p.radius * p.radius;

  int k = blockIdx.x;
  if (k >= n) return;
  stage(p, s, 0, load_meta(k, n, cy, cx, lvl));
  Meta next = load_meta(k + gridDim.x, n, cy, cx, lvl);
  for (int it = 0; k < n; ++it, k += gridDim.x) {
    const int b = it & 1;
    if (k + gridDim.x < n) {
      stage(p, s, b ^ 1, next);
      next = load_meta(k + 2 * gridDim.x, n, cy, cx, lvl);
      cp_async_wait<1>();   // this keypoint's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Slot& sl = s.slot[b];
    if (sl.level < 0) {      // outside the level table: NaN angle
      if (t < 8) desc[k * 8 + t] = 0;
      if (t == 0) angle[k] = __int_as_float(0x7fc00000);
      __syncthreads();
      continue;
    }
    float(*raw)[kRow] = s.raw[b];

    // IC moments over the central 32x32 (the unwrapped patch): float32
    // within a warp (each lane's 4 pixels, then shuffles), the 8 warps'
    // partial sums in double (the plain version sums in float32 in
    // another order; the angle is held to it within 1e-5 rad)
    float m10 = 0.f, m01 = 0.f, mass = 0.f;
#pragma unroll
    for (int j = 0; j < kPatch * kPatch / kThreads; ++j) {
      const int i = t + j * kThreads;
      const int r = i >> 5;
      const int c = i & 31;
      const int dy = r - kHalf;
      const int dx = c - kHalf;
      if (dy * dy + dx * dx <= r2) {
        const float v = raw[r + kBlurR][sl.lead[r + kBlurR] + c + kBlurR];
        m10 = fmaf(v, static_cast<float>(dx), m10);
        m01 = fmaf(v, static_cast<float>(dy), m01);
        mass += fabsf(v);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m10 += __shfl_xor_sync(0xffffffffu, m10, o);
      m01 += __shfl_xor_sync(0xffffffffu, m01, o);
      mass += __shfl_xor_sync(0xffffffffu, mass, o);
    }
    if (lane == 0) {
      s.part[0][warp] = m10;
      s.part[1][warp] = m01;
      s.part[2][warp] = mass;
    }
    __syncthreads();

    if (warp == 0) {
      // the angle, its stability gate and its rotation bin, in the plain
      // version's float32 operations
      double s10 = lane < kWarps ? s.part[0][lane] : 0.0;
      double s01 = lane < kWarps ? s.part[1][lane] : 0.0;
      double sm = lane < kWarps ? s.part[2][lane] : 0.0;
#pragma unroll
      for (int o = kWarps / 2; o > 0; o >>= 1) {
        s10 += __shfl_xor_sync(0xffffffffu, s10, o);
        s01 += __shfl_xor_sync(0xffffffffu, s01, o);
        sm += __shfl_xor_sync(0xffffffffu, sm, o);
      }
      if (lane == 0) {
        const float f10 = static_cast<float>(s10);
        const float f01 = static_cast<float>(s01);
        const float fmass = __fmul_rn(static_cast<float>(sm),
                                      static_cast<float>(p.radius));
        const float mag = __fsqrt_rn(
            __fadd_rn(__fmul_rn(f10, f10), __fmul_rn(f01, f01)));
        const float a =
            mag > __fmul_rn(p.tau, fmass) ? atan2f(f01, f10) : 0.0f;
        angle[k] = a;
        const int bb = __float2int_rn(
            __fmul_rn(__fdiv_rn(a, kTwoPi), static_cast<float>(kBins)));
        s.bin = bb & (kBins - 1);  // remainder mod 64, also for bb < 0
      }
    } else {
      // horizontal blur pass over every window row (warps 1..7), two
      // outputs per thread from 8 loads
      for (int i = t - 32; i < kWin * kPatch / 2; i += kThreads - 32) {
        const int r = i >> 4;
        const int c = (i & 15) * 2;
        const float* row = &raw[r][sl.lead[r] + c];
        float v[kTaps + 1];
#pragma unroll
        for (int q = 0; q < kTaps + 1; ++q) v[q] = row[q];
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int q = 0; q < kTaps; ++q) {
          a0 = __fadd_rn(a0, __fmul_rn(p.blur[q], v[q]));
          a1 = __fadd_rn(a1, __fmul_rn(p.blur[q], v[q + 1]));
        }
        s.hor[r][c] = a0;
        s.hor[r][c + 1] = a1;
      }
    }
    __syncthreads();

    // the bin's BRIEF samples: issue the L2 loads before the vertical pass
    const int bin = s.bin;
    const int j1 = idx1[bin * kBits + t];
    const int j2 = idx2[bin * kBits + t];

    // vertical blur pass, rounded to bf16: thread (warp, lane) makes rows
    // 4 warp .. 4 warp + 3 of column lane from 10 rows in registers
    {
      const int r0 = warp * kVRows;
      float col[kVRows + kTaps - 1];
#pragma unroll
      for (int q = 0; q < kVRows + kTaps - 1; ++q) col[q] = s.hor[r0 + q][lane];
#pragma unroll
      for (int o = 0; o < kVRows; ++o) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < kTaps; ++q)
          acc = __fadd_rn(acc, __fmul_rn(p.blur[q], col[o + q]));
        s.blurred[(r0 + o) * kPatch + lane] =
            __bfloat162float(__float2bfloat16_rn(acc));
      }
    }
    __syncthreads();

    // steered BRIEF: bit t of the keypoint's bin
    const unsigned word =
        __ballot_sync(0xffffffffu, s.blurred[j2] > s.blurred[j1]);
    if (lane == 0) desc[k * 8 + warp] = static_cast<int>(word);
    __syncthreads();   // hor, blurred and this buffer are reused
  }
}

int g_grid[64];        // blocks that fit on the card at once, per device

}  // namespace

// params: host pointer to the level table and settings; cy, cx, lvl: [n]
// int32 window corners and level slots; idx1, idx2: [64, 256] int16 flat
// patch indices; angle: [n] f32; desc: [n, 8] int32; device: the CUDA
// device of every pointer. Launches on `stream` and returns
// cudaGetLastError() (or the error of a runtime call before the launch).
extern "C" int orb_describe(const OrbParams* params, const int* cy,
                            const int* cx, const int* lvl, int n,
                            const int16_t* idx1, const int16_t* idx2,
                            float* angle, int* desc, int device,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  const int smem = static_cast<int>(sizeof(Smem));
  if (err == cudaSuccess && g_grid[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(orb_describe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, orb_describe_kernel, kThreads, smem);
    if (err == cudaSuccess) g_grid[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (err == cudaSuccess) {
    const int grid = n < g_grid[device] ? n : g_grid[device];
    orb_describe_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        *params, cy, cx, lvl, n, idx1, idx2, angle, desc);
    err = cudaGetLastError();
  }
  if (prev >= 0 && prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
