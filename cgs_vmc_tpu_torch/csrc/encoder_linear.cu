// The linear layers of a pre-LN transformer block for Hopper (sm_90a), f32,
// with the block's LayerNorm in the prologue and the bias, the tanh GELU or
// the residual add in the epilogue:
//
//   y[r, :] = epilogue(prologue(x[r, :]) @ W + b)
//   prologue: none, or LayerNorm with the block's g, β (the biased
//             variance, eps = 1e-5 inside the root):
//             g · (x − mean) · rsqrt(var + eps) + β
//   epilogue: none; the tanh GELU of F.gelu(approximate='tanh'); or
//             residual[r, :] + (·)
//
// over the rows r of a [rows, K] tensor, W in the JAX [K, N] layout as it
// stands (no transpose copy), y [rows, N].
//
// Replaces no TPU kernel: the JAX package's linears are XLA dots, whose
// neighbouring elementwise ops XLA fuses itself.  It replaces, on the
// port's no-grad forward of the transformer (models/attention.py, through
// models/encoder_linear.py), a cuBLAS f32 GEMM and the passes around it:
// the LayerNorm's mean, variance and affine passes, the bias add, the GELU
// and the residual add.  Those passes read and wrote device memory between
// GEMMs that are short in K, and took about 60% of the transformer cell's
// busy time (PERF.md).
//
// Built as one library holding the four instances a block of width 64
// uses (K → N, prologue, epilogue): qkv 64 → 192 (LayerNorm, none),
// attn_out 64 → 64 (none, residual), mlp_in 64 → 256 (LayerNorm, GELU) and
// mlp_out 256 → 64 (none, residual); the entry point picks the instance by
// its arguments.
//
// What bounds it on an H100.  Per row, qkv reads 256 B and writes 768 B for
// 24.6 kFLOP; attn_out reads 512 B (x and the residual) and writes 256 B for
// 8.2 kFLOP; mlp_in reads 256 B and writes 1 KB for 32.8 kFLOP; mlp_out
// reads 1.25 KB and writes 256 B for 32.8 kFLOP.  That is 24, 11, 26 and 21
// operations a byte, about the f32 ridge of ~20 (67 TFLOP/s of FMA on the
// CUDA cores, 3.35 TB/s): attn_out is bound by device memory, the other
// three by FMA issue, all near the balance point.  TF32 tensor cores are
// out: the configuration states f32.
//
// Design:
//  * A block of 4 warps takes BM = 128 rows and every output column.  Its
//    A tile (the rows' K values, or a 32-wide chunk of them when K = 256)
//    and W's 64-column tiles (or W's 32-row chunks) arrive in shared
//    memory by 16-byte cp.async, double-buffered: stage s + 1 is in flight
//    while stage s's FMAs run.  A stage is one (k chunk, column tile) pair:
//    for K = 64 the A tile stays and W's column tiles stream past it; for
//    K = 256 (one column tile) A's and W's k chunks stream together.  The
//    A rows are padded by 4 floats, so that a warp's float4 loads of four
//    neighbouring rows fall in other banks.  Three blocks fit a
//    multiprocessor (≤ 67 KB of shared memory and ≤ 170 registers a thread
//    each), so one's loads and epilogue overlap the others' FMAs.  A
//    proposal's 147,456 rows make 1,152 blocks, 2.9 waves of 396; blocks
//    of 256 rows made 2.2 waves of 264, the last mostly empty, and were
//    up to 22% slower there (PERF.md).
//  * The LayerNorm (K = 64 only) works on the A tile in shared memory,
//    before the first FMA: each warp normalises the rows it multiplies (8
//    lanes a row, their sums by shuffles; the mean first, then the sum of
//    squared deviations from it), in place.  The normalised rows never
//    reach device memory.
//  * A thread owns 8 rows (r + 4i) × 8 columns (4c .. 4c+3 and 32+4c ..
//    32+4c+3) of a column tile, a warp 32 rows × 64 columns, 64
//    accumulators.  Per 4 values of k it loads its 8 rows' float4s and W's
//    8 float4s (broadcast across the warp's row groups) from shared
//    memory: 16 loads for 256 FMAs.  (16 rows a thread, 128 accumulators,
//    read less of shared memory an FMA and ran 10% faster at 5.3 M rows,
//    but needed 255 registers, so only two blocks of 4 warps fit, and ran
//    slower at a proposal's rows, where most of the cell's calls are.)
//  * The epilogue works on the registers: + b, then the GELU with the
//    formula and the constants of torch's CUDA kernel (tanhf), or the
//    residual's float4s read once from device memory and added; 16-byte
//    stores, each warp store 4 rows × 128 contiguous bytes.
//  * The summation order is fixed (k ascending into each accumulator) and
//    there are no atomics: two calls, and a graph replay and an eager call,
//    agree bit for bit.  No fast math: tanhf and rsqrtf as the plain
//    route's kernels call them.
//
// Takes rows ≥ 0 and x, the residual and y 16-byte aligned (else invalid
// value); W, b, g and β at any float alignment (W's copies fall back to
// 4-byte cp.async when W is not 16-byte aligned).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;                     // rows a thread
constexpr int WARP_ROWS = 4 * TM;         // rows a warp
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;             // blocks a multiprocessor
constexpr int BM = WARPS * WARP_ROWS;     // rows a block
constexpr int BN = 64;                    // output columns a stage
constexpr int KA = 4;                     // k values an A load
constexpr int kMaxDevices = 64;
constexpr float kEps = 1e-5f;

enum Epilogue { kNone = 0, kGelu = 1, kResidual = 2 };

// The stages of an instance: K → N, LayerNorm or not.
template <int K, int N, bool LN>
struct Tiles {
  static constexpr int KC = K <= 64 ? K : 32;   // k values a stage
  static constexpr int KSTAGES = K / KC;
  static constexpr int NTILES = N / BN;
  static constexpr int STAGES = KSTAGES * NTILES;
  static constexpr int AS = KC + 4;  // an A row's stride in shared memory
  static constexpr int ABUFS = KSTAGES > 1 ? 2 : 1;
  static constexpr int A_FLOATS = BM * AS;
  static constexpr int W_FLOATS = KC * BN;
  static constexpr size_t SHARED_BYTES =
      sizeof(float) * (ABUFS * A_FLOATS + 2 * W_FLOATS);
  static_assert(K % KC == 0 && KC % 4 == 0 && N % BN == 0, "tile shapes");
  static_assert(KSTAGES == 1 || NTILES == 1, "stream k or n, not both");
  static_assert(!LN || K == 64, "the LayerNorm prologue takes rows of 64");
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues stage s's copies: its A rows (the first stage, or every stage
// when k streams; rows past `rows` are zero-filled) and W's (k chunk,
// column tile) into buffer s % 2.
template <int K, int N, bool LN>
__device__ __forceinline__ void load_stage(int s, const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           float* a_buf, float* w_buf,
                                           int row0, int rows,
                                           bool w_aligned) {
  using T = Tiles<K, N, LN>;
  const int kc = s % T::KSTAGES;
  const int ct = s / T::KSTAGES;
  if (s == 0 || T::KSTAGES > 1) {
    float* dst = a_buf + (s % T::ABUFS) * T::A_FLOATS;
    constexpr int CHUNKS = T::KC / 4;
    for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS;
      const int c = i - r * CHUNKS;
      const bool in = row0 + r < rows;
      const float* src =
          x + (size_t)(in ? row0 + r : 0) * K + kc * T::KC + 4 * c;
      cp_async16(dst + r * T::AS + 4 * c, src, in ? 16 : 0);
    }
  }
  float* dst = w_buf + (s % 2) * T::W_FLOATS;
  const float* src = w + (size_t)kc * T::KC * N + ct * BN;
  if (w_aligned) {
    for (int i = threadIdx.x; i < T::KC * BN / 4; i += THREADS) {
      const int k = i / (BN / 4);
      const int c = i - k * (BN / 4);
      cp_async16(dst + k * BN + 4 * c, src + (size_t)k * N + 4 * c, 16);
    }
  } else {
    for (int i = threadIdx.x; i < T::KC * BN; i += THREADS) {
      const int k = i / BN;
      const int c = i - k * BN;
      cp_async4(dst + k * BN + c, src + (size_t)k * N + c);
    }
  }
  cp_async_commit();
}

// LayerNorm of a warp's WARP_ROWS rows (from `a`) of a tile of 64-value
// rows with stride AS, in place: 4 rows at a time, 8 lanes a row, lane s
// holding columns 4s..4s+3 and 32+4s..32+4s+3.
template <int AS>
__device__ __forceinline__ void layernorm_rows(
    float* a, int lane, const float* __restrict__ g,
    const float* __restrict__ beta) {
  const int r = lane / 8;
  const int c0 = 4 * (lane % 8);
  float gv[8], bv[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    gv[j] = __ldg(g + c0 + j), gv[4 + j] = __ldg(g + c0 + 32 + j);
    bv[j] = __ldg(beta + c0 + j), bv[4 + j] = __ldg(beta + c0 + 32 + j);
  }
  for (int it = 0; it < WARP_ROWS; it += 4) {
    float* row = a + (it + r) * AS;
    const float4 u0 = *reinterpret_cast<const float4*>(row + c0);
    const float4 u1 = *reinterpret_cast<const float4*>(row + c0 + 32);
    float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[j];
#pragma unroll
    for (int m = 1; m < 8; m *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    const float mean = sum / 64.0f;
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = v[j] - mean;
      ss += d * d;
    }
#pragma unroll
    for (int m = 1; m < 8; m *= 2) ss += __shfl_xor_sync(0xffffffffu, ss, m);
    const float rstd = rsqrtf(ss / 64.0f + kEps);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = gv[j] * (v[j] - mean) * rstd + bv[j];
    *reinterpret_cast<float4*>(row + c0) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + c0 + 32) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

// torch's CUDA gelu(approximate='tanh'), its constants and order.
__device__ __forceinline__ float gelu_tanh(float v) {
  constexpr float kBeta = 0.7978845608028654f;  // √2 · (2/√π) · 0.5
  constexpr float kKappa = 0.044715f;
  const float cube = v * v * v;
  const float inner = kBeta * (v + kKappa * cube);
  return 0.5f * v * (1.0f + tanhf(inner));
}

template <int K, int N, bool LN, int EPI>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    encoder_linear_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ g,
                          const float* __restrict__ beta,
                          const float* __restrict__ res,
                          float* __restrict__ out, const int rows,
                          const bool w_aligned) {
  using T = Tiles<K, N, LN>;
  // The k loop's unrolling: twice, but not at all in the GELU instance,
  // which ran 3-4% faster so on the card (PERF.md).
  constexpr int UNROLL = EPI == kGelu ? 1 : 2;
  extern __shared__ __align__(16) float smem[];
  float* a_buf = smem;
  float* w_buf = smem + T::ABUFS * T::A_FLOATS;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * WARP_ROWS + lane / 8;  // rows wrow + 4i
  const int tc = lane % 8;  // columns 4tc.. and 32+4tc.. of a tile

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_stage<K, N, LN>(0, x, w, a_buf, w_buf, row0, rows, w_aligned);
  for (int s = 0; s < T::STAGES; ++s) {
    // Stage s has landed, and every thread is past stage s − 1's FMAs, so
    // stage s + 1 may overwrite its buffers.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (LN) {
      if (s == 0) {
        layernorm_rows<T::AS>(a_buf + warp * WARP_ROWS * T::AS, lane, g,
                              beta);
        __syncwarp();
      }
    }
    if (s + 1 < T::STAGES)
      load_stage<K, N, LN>(s + 1, x, w, a_buf, w_buf, row0, rows, w_aligned);

    const float* a = a_buf + (s % T::ABUFS) * T::A_FLOATS + wrow * T::AS;
    const float* wt = w_buf + (s % 2) * T::W_FLOATS + 4 * tc;
#pragma unroll UNROLL
    for (int k = 0; k < T::KC; k += KA) {
      float af[TM * KA];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 u =
            *reinterpret_cast<const float4*>(a + 4 * i * T::AS + k);
        af[4 * i] = u.x, af[4 * i + 1] = u.y;
        af[4 * i + 2] = u.z, af[4 * i + 3] = u.w;
      }
#pragma unroll
      for (int kk = 0; kk < KA; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(wt + (k + kk) * BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(wt + (k + kk) * BN + 32);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = af[KA * i + kk];
          acc[i][0] = fmaf(ai, b0.x, acc[i][0]);
          acc[i][1] = fmaf(ai, b0.y, acc[i][1]);
          acc[i][2] = fmaf(ai, b0.z, acc[i][2]);
          acc[i][3] = fmaf(ai, b0.w, acc[i][3]);
          acc[i][4] = fmaf(ai, b1.x, acc[i][4]);
          acc[i][5] = fmaf(ai, b1.y, acc[i][5]);
          acc[i][6] = fmaf(ai, b1.z, acc[i][6]);
          acc[i][7] = fmaf(ai, b1.w, acc[i][7]);
        }
      }
    }
    if (s % T::KSTAGES != T::KSTAGES - 1) continue;

    // The column tile is summed: + b, the epilogue, store; then start the
    // next tile's sums from zero.
    const int c0 = (s / T::KSTAGES) * BN + 4 * tc;
    float bv[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = __ldg(bias + c0 + j), bv[4 + j] = __ldg(bias + c0 + 32 + j);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + wrow + 4 * i;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = acc[i][j] + bv[j];
        acc[i][j] = 0.0f;
      }
      if (row >= rows) continue;
      if (EPI == kGelu) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = gelu_tanh(v[j]);
      }
      if (EPI == kResidual) {
        const float* r = res + (size_t)row * N + c0;
        const float4 r0 = *reinterpret_cast<const float4*>(r);
        const float4 r1 = *reinterpret_cast<const float4*>(r + 32);
        v[0] = r0.x + v[0], v[1] = r0.y + v[1];
        v[2] = r0.z + v[2], v[3] = r0.w + v[3];
        v[4] = r1.x + v[4], v[5] = r1.y + v[5];
        v[6] = r1.z + v[6], v[7] = r1.w + v[7];
      }
      float* o = out + (size_t)row * N + c0;
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 32) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <int K, int N, bool LN, int EPI>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* g, const float* beta, const float* res,
                   float* out, int rows, cudaStream_t stream) {
  using T = Tiles<K, N, LN>;
  static bool configured[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(encoder_linear_kernel<K, N, LN, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)T::SHARED_BYTES);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int grid = (rows + BM - 1) / BM;
  encoder_linear_kernel<K, N, LN, EPI>
      <<<grid, THREADS, T::SHARED_BYTES, stream>>>(
          x, w, bias, g, beta, res, out, rows, ((uintptr_t)w & 15) == 0);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15) != 0; }

}  // namespace

extern "C" {

// out [rows, n] = epilogue(prologue(x [rows, k]) @ w [k, n] + bias [n]):
// prologue the LayerNorm with g, beta [k] when `layernorm` is 1, else none;
// epilogue 0 none, 1 the tanh GELU, 2 + residual [rows, n].  Device
// pointers to contiguous float32; x, residual and out 16-byte aligned; g,
// beta and residual may be null where unused.  (k, n, layernorm, epilogue)
// must be one of the built instances: (64, 192, 1, 0), (64, 64, 0, 2),
// (64, 256, 1, 1), (256, 64, 0, 2).  Launches on `stream` and does not
// synchronise.  Returns a cudaError_t (invalid value for what the kernel
// does not take).
int encoder_linear_f32(const float* x, const float* w, const float* bias,
                       const float* g, const float* beta,
                       const float* residual, float* out, int rows, int k,
                       int n, int layernorm, int epilogue, void* stream) {
  if (rows < 0 || !x || !w || !bias || !out || misaligned(x) ||
      misaligned(out) || (layernorm && (!g || !beta)) ||
      (epilogue == kResidual && (!residual || misaligned(residual))))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
#define ENCODER_LINEAR_INSTANCE(K, N, LN, EPI)                             \
  if (k == K && n == N && (layernorm != 0) == LN && epilogue == EPI)       \
    return (int)launch<K, N, LN, EPI>(x, w, bias, g, beta, residual, out, \
                                      rows, s);
  ENCODER_LINEAR_INSTANCE(64, 192, true, kNone)
  ENCODER_LINEAR_INSTANCE(64, 64, false, kResidual)
  ENCODER_LINEAR_INSTANCE(64, 256, true, kGelu)
  ENCODER_LINEAR_INSTANCE(256, 64, false, kResidual)
#undef ENCODER_LINEAR_INSTANCE
  return (int)cudaErrorInvalidValue;
}

const char* encoder_linear_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
