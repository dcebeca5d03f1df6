// Periodic 2-D convolution (cross-correlation) for Hopper (sm_90a), f32,
// with the bias and an optional ReLU in the epilogue.
//
// Replaces no TPU kernel: the JAX package's conv is XLA's lax.conv.  It
// replaces, on the port's no-grad forward (models/nn.py,
// conv2d_periodic_apply), the route wrap padding (two torch.cat copies of
// every layer's input) + an unpadded cuDNN conv + the bias add + the ReLU:
// four or five launches and three extra passes over the activations, which
// took about half the flagship epoch's busy time (PERF.md).
//
//   out[b, co, x, y] = bias[co] + Σ_{dx,dy,ci} w[dx, dy, ci, co]
//                      · in[b, ci, (x + dx − lo) mod L_x, (y + dy − lo) mod L_y]
//
// lo: the padding before, from models/nn.py::_pad_widths_2d (odd k pads
// (k−1)/2 on both sides, even k pads k/2 − 1 before and k/2 after); the
// host passes it at build time, so the rule has one home.  No padded
// tensor exists.
//
// Built once for each (k, L_y) a process meets, with k, L_y and lo as
// PERIODIC_CONV_K, PERIODIC_CONV_SIZE_Y and PERIODIC_CONV_LO
// (models/periodic_conv2d.py), so a run compiles only the shapes it uses.
//
// What bounds it on an H100.  A 32→32 k=3 layer on 16,384 images of 6×6 is
// 10.9 GFLOP (2·k²·C_in·C_out·L² an image) against ~151 MB in and out: ~72
// operations a byte, over the f32 ridge of ~20 (67 TFLOP/s of FMA on the
// CUDA cores, 3.35 TB/s).  So it is bound by f32 FMA issue: 0.162 ms at
// peak.  TF32 tensor cores are out: the port runs its convs in full f32.
//
// Design:
//  * Persistent blocks, one a streaming multiprocessor at the main shapes.
//    Each block stages the layer's weight once in shared memory in the
//    JAX HWIO layout, [k·k·C_in, C_out] rounded up to 4 channels, which is
//    already the GEMM's K × N operand, and the bias; then walks over tiles
//    of whole images.
//  * A tile of T images is one contiguous run of T·C_in·L² floats (NCHW),
//    copied into shared memory with 16-byte cp.async, double-buffered: the
//    next tile arrives while this one's FMAs run.  An image's slot in
//    shared memory holds the larger of its input and its output, padded by
//    4 floats so that neighbouring images of a warp start in other banks.
//  * A thread's item is R whole output rows × 4 output channels of one
//    image (R·L_y·4 accumulators).  Per input channel it holds the k×k
//    weight float4s in registers (broadcast loads from shared memory) where
//    they fit, k ≤ 4; a larger k (5 is Config's default) loads each weight
//    at its use, R·k² loads a channel.  It loads each of its R + k − 1 source rows once, with float4 or float2
//    loads where L_y allows.  Its source rows are wrapped once a tile;
//    along y the wrap is a rotation of the row's registers by compile-time
//    offsets.  At the flagship's shape an item issues 21 shared-memory
//    loads for 432 FMAs a channel.
//  * R comes from L_y and k by a fixed rule (rows_per_item) that keeps the
//    accumulators, weights and a row under ~112 registers, so 512 threads
//    a block fit the register file.
//  * One item a thread a tile.  The epilogue adds the bias, applies the
//    ReLU if asked (v < 0 ? 0 : v, so a NaN stays NaN as in torch.relu)
//    and writes the item's R rows of each channel into the tile's own
//    buffer, once every item has read it; the tile's outputs, one
//    contiguous run of T·C_out·L² floats in NCHW, then leave with coalesced
//    16-byte stores.  (Stored straight from the registers, a warp's 16-byte
//    pieces lay 576 B apart, and the stores alone took 0.10 ms of a 32→32
//    layer on 16,384 images: PERF.md.)
//  * The summation order is fixed (channels in order, then taps) and there
//    are no atomics: two calls, and a graph replay and an eager call, agree
//    bit for bit.
//
// Takes k ≤ 8 and L_y ≤ 32 (at build time); L_x ≤ 256, at most 512 items
// an image, and a weight that fits the shared memory with two images (at
// launch, else invalid value).

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(PERIODIC_CONV_K) || !defined(PERIODIC_CONV_SIZE_Y) || \
    !defined(PERIODIC_CONV_LO)
#error "build with -DPERIODIC_CONV_K=k -DPERIODIC_CONV_SIZE_Y=L_y -DPERIODIC_CONV_LO=lo"
#endif

namespace {

constexpr int K = PERIODIC_CONV_K;
constexpr int LY = PERIODIC_CONV_SIZE_Y;
constexpr int LO = PERIODIC_CONV_LO;
static_assert(1 <= K && K <= 8, "k must be 1..8");
static_assert(1 <= LY && LY <= 32, "L_y must be 1..32");
static_assert(0 <= LO && LO < K, "lo must be in [0, k)");

constexpr int kMaxSizeX = 256;
constexpr int kThreads = 512;
constexpr int kChannels = 4;  // output channels an item
constexpr int kMaxDevices = 64;
constexpr int kRegisterBudget = 112;
constexpr bool kHoldWeights = K <= 4;
constexpr int kWeightRegisters = kHoldWeights ? 4 * K * K : 4;

struct Shape {
  int batch, c_in, c_out, size_x;
  int groups;            // ⌈C_out / 4⌉ channel groups
  int row_groups;        // ⌈L_x / R⌉
  int items_per_image;   // groups · row_groups
  int image_floats;      // C_in · L_x · L_y
  int out_floats;        // C_out · L_x · L_y
  int image_stride;      // floats between images in shared memory
  int tile_images;       // T
  int num_tiles;
  int weight_floats;     // k·k·C_in · 4·groups
  int relu;
};

// Output rows an item: the largest divisor of L_y (a lattice is square as
// a rule, so no row group is left part-empty) that keeps the accumulators
// (4·R·L_y), the weights (4·k² held, else one float4), a source row (L_y) and the R + k − 1 row
// offsets within kRegisterBudget.
__host__ __device__ constexpr int rows_per_item() {
  const int fit =
      (kRegisterBudget - kWeightRegisters - LY - (K - 1)) / (4 * LY + 1);
  for (int r = fit < LY ? fit : LY; r > 1; --r)
    if (LY % r == 0) return r;
  return 1;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issues the copies of tile `tile`'s images into `buf`.
__device__ __forceinline__ void stage_tile(float* buf, const float* x,
                                           const Shape& s, int tile,
                                           bool vec) {
  const int b0 = tile * s.tile_images;
  const int n = min(s.tile_images, s.batch - b0);
  const float* src = x + (size_t)b0 * s.image_floats;
  if (vec) {
    const int chunks = s.image_floats / 4;
    for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
      const int t = i / chunks;
      const int c = i - t * chunks;
      cp_async16(buf + t * s.image_stride + 4 * c,
                 src + (size_t)t * s.image_floats + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < n * s.image_floats; i += blockDim.x) {
      const int t = i / s.image_floats;
      const int c = i - t * s.image_floats;
      cp_async4(buf + t * s.image_stride + c, src + i);
    }
  }
}

__device__ __forceinline__ float epilogue(float acc, float bias, int relu) {
  const float v = acc + bias;
  return relu && v < 0.0f ? 0.0f : v;
}

__global__ void __launch_bounds__(kThreads, 1)
    periodic_conv2d_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, const Shape s) {
  constexpr int R = rows_per_item();
  constexpr int P = R + K - 1;    // source rows an item

  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* b_s = w_s + s.weight_floats;
  // The two tile buffers.  Each is addressed as buf0 + offset, never picked
  // from an array of pointers: that would make every access a generic one.
  float* buf0 = b_s + 4 * s.groups;
  const int buf_floats = s.tile_images * s.image_stride;

  const int c4 = 4 * s.groups;
  for (int i = threadIdx.x; i < s.weight_floats; i += blockDim.x) {
    const int k_row = i / c4;
    const int co = i - k_row * c4;
    w_s[i] = co < s.c_out ? w[(size_t)k_row * s.c_out + co] : 0.0f;
  }
  for (int i = threadIdx.x; i < c4; i += blockDim.x)
    b_s[i] = i < s.c_out ? bias[i] : 0.0f;

  const bool vec = s.image_floats % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_out =
      s.out_floats % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  const int plane = s.size_x * LY;

  int tile = blockIdx.x;
  if (tile < s.num_tiles) stage_tile(buf0, x, s, tile, vec);
  cp_async_commit();
  for (int it = 0; tile < s.num_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < s.num_tiles)
      stage_tile(buf0 + ((it + 1) & 1) * buf_floats, x, s, next, vec);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();

    float* buf = buf0 + (it & 1) * buf_floats;
    const int b0 = tile * s.tile_images;
    const int n = min(s.tile_images, s.batch - b0);
    const int item = threadIdx.x;  // one item a thread (plan)
    const bool active = item < n * s.items_per_image;
    const int t = item / s.items_per_image;
    const int rem = item - t * s.items_per_image;
    const int rg = rem / s.groups;
    const int cg = rem - rg * s.groups;
    const int x0 = rg * R;

    float acc[R][LY][kChannels];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int y = 0; y < LY; ++y)
#pragma unroll
        for (int c = 0; c < kChannels; ++c) acc[r][y][c] = 0.0f;

    if (active) {
      int row_off[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        row_off[p] = ((x0 + p - LO) % s.size_x + s.size_x) % s.size_x * LY;
      const float* image = buf + t * s.image_stride;
      for (int ci = 0; ci < s.c_in; ++ci) {
        const float* chan = image + ci * plane;
        float4 wr[K][K];
        if constexpr (kHoldWeights) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int dy = 0; dy < K; ++dy)
              wr[dx][dy] = w4[((dx * K + dy) * s.c_in + ci) * s.groups + cg];
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float* row = chan + row_off[p];
          float v[LY];
          if constexpr (LY % 4 == 0) {
#pragma unroll
            for (int q = 0; q < LY; q += 4) {
              const float4 f = *reinterpret_cast<const float4*>(row + q);
              v[q] = f.x, v[q + 1] = f.y, v[q + 2] = f.z, v[q + 3] = f.w;
            }
          } else if constexpr (LY % 2 == 0) {
#pragma unroll
            for (int q = 0; q < LY; q += 2) {
              const float2 f = *reinterpret_cast<const float2*>(row + q);
              v[q] = f.x, v[q + 1] = f.y;
            }
          } else {
#pragma unroll
            for (int q = 0; q < LY; ++q) v[q] = row[q];
          }
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const int r = p - dx;
            if (r < 0 || r >= R) continue;
#pragma unroll
            for (int dy = 0; dy < K; ++dy) {
              float4 wv;
              if constexpr (kHoldWeights)
                wv = wr[dx][dy];
              else
                wv = w4[((dx * K + dy) * s.c_in + ci) * s.groups + cg];
#pragma unroll
              for (int y = 0; y < LY; ++y) {
                const float a = v[((y + dy - LO) % LY + LY) % LY];
                acc[r][y][0] = fmaf(a, wv.x, acc[r][y][0]);
                acc[r][y][1] = fmaf(a, wv.y, acc[r][y][1]);
                acc[r][y][2] = fmaf(a, wv.z, acc[r][y][2]);
                acc[r][y][3] = fmaf(a, wv.w, acc[r][y][3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every item has read the tile: it takes the outputs

    if (active) {
      const int rows_here = min(R, s.size_x - x0);
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        const int co = cg * kChannels + c;
        if (co >= s.c_out) break;
        const float bv = b_s[co];
        float* dst = buf + t * s.image_stride + co * plane + x0 * LY;
        if constexpr ((R * LY) % 4 == 0) {
          if (rows_here == R && ((uintptr_t)dst & 15) == 0) {
#pragma unroll
            for (int q = 0; q < R * LY; q += 4) {
              float4 f;
              f.x = epilogue(acc[q / LY][q % LY][c], bv, s.relu);
              f.y = epilogue(acc[(q + 1) / LY][(q + 1) % LY][c], bv, s.relu);
              f.z = epilogue(acc[(q + 2) / LY][(q + 2) % LY][c], bv, s.relu);
              f.w = epilogue(acc[(q + 3) / LY][(q + 3) % LY][c], bv, s.relu);
              *reinterpret_cast<float4*>(dst + q) = f;
            }
            continue;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= rows_here) break;
#pragma unroll
          for (int y = 0; y < LY; ++y)
            dst[r * LY + y] = epilogue(acc[r][y][c], bv, s.relu);
        }
      }
    }
    __syncthreads();

    // The tile's outputs, contiguous in NCHW, with coalesced stores.
    float* dst = out + (size_t)b0 * s.out_floats;
    if (vec_out) {
      const int chunks = s.out_floats / 4;
      for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
        const int ti = i / chunks;
        const int c = i - ti * chunks;
        *reinterpret_cast<float4*>(dst + 4 * i) =
            *reinterpret_cast<const float4*>(buf + ti * s.image_stride +
                                             4 * c);
      }
    } else {
      for (int i = threadIdx.x; i < n * s.out_floats; i += blockDim.x) {
        const int ti = i / s.out_floats;
        dst[i] = buf[ti * s.image_stride + i - ti * s.out_floats];
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
}

struct Args {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  int batch, c_in, c_out, size_x, relu;
};

size_t shared_bytes(const Shape& s) {
  return sizeof(float) * ((size_t)s.weight_floats + 4 * s.groups +
                          2 * (size_t)s.tile_images * s.image_stride);
}

// The shape of a launch with the most images a tile that fit both the
// threads of a block, one item a thread, and the shared memory (at least
// one).
cudaError_t plan(const Args& a, int smem_optin, Shape* s) {
  constexpr int R = rows_per_item();
  s->batch = a.batch;
  s->c_in = a.c_in;
  s->c_out = a.c_out;
  s->size_x = a.size_x;
  s->groups = (a.c_out + kChannels - 1) / kChannels;
  s->row_groups = (a.size_x + R - 1) / R;
  s->items_per_image = s->groups * s->row_groups;
  s->image_floats = a.c_in * a.size_x * LY;
  s->out_floats = a.c_out * a.size_x * LY;
  const int larger = s->image_floats > s->out_floats ? s->image_floats
                                                     : s->out_floats;
  s->image_stride = (larger + 3) / 4 * 4 + 4;
  s->weight_floats = K * K * a.c_in * 4 * s->groups;
  s->relu = a.relu;
  if (s->items_per_image > kThreads) return cudaErrorInvalidValue;
  int t = kThreads / s->items_per_image;
  t = t < a.batch ? t : (a.batch > 0 ? a.batch : 1);
  s->tile_images = t;
  while (s->tile_images > 1 && shared_bytes(*s) > (size_t)smem_optin)
    --s->tile_images;
  if (shared_bytes(*s) > (size_t)smem_optin) return cudaErrorInvalidValue;
  s->num_tiles = (a.batch + s->tile_images - 1) / s->tile_images;
  return cudaSuccess;
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

cudaError_t device_info(DeviceInfo* info, int* dev) {
  static DeviceInfo cache[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& c = cache[*dev];
  if (!c.sms) {
    err = cudaDeviceGetAttribute(&c.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                 *dev);
    if (err != cudaSuccess) return err;
  }
  *info = c;
  return cudaSuccess;
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.batch < 0 || a.c_in < 1 || a.c_out < 1 || a.size_x < 1 ||
      a.size_x > kMaxSizeX)
    return cudaErrorInvalidValue;
  static bool configured[kMaxDevices];
  DeviceInfo info;
  int dev = 0;
  cudaError_t err = device_info(&info, &dev);
  if (err != cudaSuccess) return err;
  Shape s;
  err = plan(a, info.smem_optin, &s);
  if (err != cudaSuccess || a.batch == 0) return err;
  auto kernel = periodic_conv2d_kernel;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               info.smem_optin);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int items = s.tile_images * s.items_per_image;
  int threads = items < kThreads ? (items + 31) / 32 * 32 : kThreads;
  const size_t smem = shared_bytes(s);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  per_sm = per_sm < 1 ? 1 : per_sm;
  const int grid =
      s.num_tiles < per_sm * info.sms ? s.num_tiles : per_sm * info.sms;
  kernel<<<grid, threads, smem, stream>>>(a.x, a.w, a.bias, a.out, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [batch, c_out, size_x, size_y] = the periodic k×k cross-correlation of
// x [batch, c_in, size_x, size_y] (NCHW) with w [k, k, c_in, c_out] (HWIO),
// plus bias [c_out], then max(·, 0) if relu.  Device pointers to contiguous
// float32; size_y and kernel must be the build's.  Launches on `stream` and
// does not synchronise.  Returns a cudaError_t (invalid value for a shape
// the kernel does not take).
int periodic_conv2d_f32(const float* x, const float* w, const float* bias,
                        float* out, int batch, int c_in, int c_out,
                        int size_x, int size_y, int kernel, int relu,
                        void* stream) {
  if (size_y != LY || kernel != K) return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, out, batch, c_in, c_out, size_x, relu};
  return (int)launch(a, (cudaStream_t)stream);
}

const char* periodic_conv2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
