// Multi-head softmax attention over one image's tokens for Hopper (sm_90a),
// f32: softmax(q kᵀ / √d_h) v for every head of every image in one launch.
//
// Replaces no TPU kernel: the JAX package's attention is XLA einsums.  It
// replaces, on the port's no-grad forward of the transformer
// (models/attention.py, SpinTransformer._attention), the attention core
// between the qkv and attn_out projections: the einsums' permute copies of
// q, k, v and the output, two batched products at d_h = 8, the scale pass
// over the [B·heads, n, n] logits and the softmax over them.  Those passes
// wrote and re-read the logits several times and took the larger part of
// the attention branch (PERF.md).
//
//   out[b, q, h·d_h + j] = Σ_k p[b, h, q, k] · v[b, k, h, j],
//   p[b, h, q, ·] = softmax_k((Σ_j q[b, q, h, j] · k[b, k, h, j]) · c),
//   c = 1 / √d_h rounded to f32, as the plain route's scale pass applies it
//
// with q, k, v read from the qkv projection's output as it stands, [B, n,
// 3·d] contiguous, whose token row is laid out 3 × heads × d_h (the order
// of qkv.reshape(B, n, 3, heads, d_h)); the output is [B, n, d], the layout
// attn_out's linear layer takes.  No logits tensor and no copy of q, k or v
// exists in device memory.
//
// Built once for each (n, heads, d_h) a process meets, with them as
// SPIN_ATTENTION_N, SPIN_ATTENTION_HEADS and SPIN_ATTENTION_HEAD_DIM
// (models/spin_attention.py), so the score and output loops unroll fully
// and the n scores of a thread stay in registers.
//
// What bounds it on an H100.  At the transformer's shape (n = 36, 8 heads
// of 8) an image reads its 27.6 KB qkv slab and writes 9.2 KB; its two
// products are 2·2·n²·d = 0.33 MFLOP, ~9 operations a byte, under the f32
// ridge of ~20 (67 TFLOP/s of FMA on the CUDA cores, 3.35 TB/s).  So it is
// bound by device memory: 0.045 ms for the 4,096 images of a proposal.
// TF32 tensor cores are out (the configuration states f32) and not needed.
//
// Design:
//  * One block takes IMAGES whole images (one at the transformer's shape,
//    n·heads = 288 threads; more where an image has few (query, head)
//    pairs).  It copies their qkv slabs, contiguous in device memory, into
//    shared memory with 16-byte cp.async (coalesced), each token row padded
//    by 4 floats so that threads on neighbouring queries read other banks.
//    Several blocks on a multiprocessor overlap one's copy with another's
//    arithmetic.
//  * A thread's item is one (query, head) pair, the query fastest, so a
//    warp spans at most two heads and its reads of a k or v row are
//    broadcasts.  It holds its q (d_h floats) and its n scores in
//    registers.
//  * The arithmetic follows the plain route's: each score a dot product
//    over j in order, then times c; an exact two-pass softmax (the max,
//    then exp(s − max) and their sum, then each exp divided by the sum, as
//    torch's softmax does); then Σ_k p_k v_k in order of k.  expf and the
//    division are the accurate ones (no fast math).  No online rescaling:
//    the scores fit in registers.
//  * Each thread writes its d_h outputs with 16-byte stores: one 32-byte
//    sector at d_h = 8.
//  * A fixed order of every sum and no atomics: two calls, and a graph
//    replay and an eager call, agree bit for bit.
//
// Takes n ≤ 64 and d_h ∈ {4, 8, 16} (at build time), 16-byte aligned
// pointers and images whose slab fits the shared memory (at launch, else
// invalid value).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(SPIN_ATTENTION_N) || !defined(SPIN_ATTENTION_HEADS) || \
    !defined(SPIN_ATTENTION_HEAD_DIM)
#error "build with -DSPIN_ATTENTION_N=n -DSPIN_ATTENTION_HEADS=heads -DSPIN_ATTENTION_HEAD_DIM=d_h"
#endif

namespace {

constexpr int N = SPIN_ATTENTION_N;
constexpr int NH = SPIN_ATTENTION_HEADS;
constexpr int DH = SPIN_ATTENTION_HEAD_DIM;
static_assert(1 <= N && N <= 64, "n must be 1..64");
static_assert(DH == 4 || DH == 8 || DH == 16, "d_h must be 4, 8 or 16");
static_assert(NH >= 1, "heads must be positive");

constexpr int D = NH * DH;                 // model width
constexpr int ROW = 3 * D;                 // floats of a token's qkv row
constexpr int ROW_S = ROW + 4;             // its stride in shared memory
constexpr int ITEMS = N * NH;              // (query, head) pairs an image
constexpr int kTargetThreads = 256;
constexpr int IMAGES = ITEMS >= kTargetThreads ? 1 : kTargetThreads / ITEMS;
constexpr int kMaxThreads = 1024;
constexpr int THREADS = (IMAGES * ITEMS + 31) / 32 * 32 < kMaxThreads
                            ? (IMAGES * ITEMS + 31) / 32 * 32
                            : kMaxThreads;
constexpr size_t SHARED_BYTES = sizeof(float) * IMAGES * N * ROW_S;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// dst[0..DH) = src[0..DH), by float4 (both 16-byte aligned).
__device__ __forceinline__ void load_row(float* dst, const float* src) {
#pragma unroll
  for (int j = 0; j < DH; j += 4) {
    const float4 f = *reinterpret_cast<const float4*>(src + j);
    dst[j] = f.x, dst[j + 1] = f.y, dst[j + 2] = f.z, dst[j + 3] = f.w;
  }
}

__global__ void __launch_bounds__(THREADS)
    spin_attention_kernel(const float* __restrict__ qkv,
                          float* __restrict__ out, const int batch) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * IMAGES;
  const int images = min(IMAGES, batch - b0);
  const float* src = qkv + (size_t)b0 * N * ROW;

  // The block's slabs: token row r (image r / N) at smem + r·ROW_S.
  constexpr int CHUNKS = ROW / 4;
  for (int i = threadIdx.x; i < images * N * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = i - r * CHUNKS;
    cp_async16(smem + r * ROW_S + 4 * c, src + (size_t)r * ROW + 4 * c);
  }
  cp_async_wait_all();
  __syncthreads();

  // The plain route multiplies the logits by the f32 reciprocal of the f32
  // √d_h (a division by a host scalar becomes that product on the card).
  const float scale = 1.0f / sqrtf((float)DH);
  for (int item = threadIdx.x; item < images * ITEMS; item += THREADS) {
    const int t = item / ITEMS;
    const int rem = item - t * ITEMS;
    const int h = rem / N;
    const int qi = rem - h * N;
    const float* image = smem + t * N * ROW_S;

    float q[DH];
    load_row(q, image + qi * ROW_S + h * DH);
    float s[N];
    float top = -INFINITY;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float kr[DH];
      load_row(kr, image + k * ROW_S + D + h * DH);
      float dot = q[0] * kr[0];
#pragma unroll
      for (int j = 1; j < DH; ++j) dot = fmaf(q[j], kr[j], dot);
      s[k] = dot * scale;
      top = fmaxf(top, s[k]);
    }
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[k] = expf(s[k] - top);
      sum += s[k];
    }
    float o[DH];
#pragma unroll
    for (int j = 0; j < DH; ++j) o[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float p = s[k] / sum;
      float vr[DH];
      load_row(vr, image + k * ROW_S + 2 * D + h * DH);
#pragma unroll
      for (int j = 0; j < DH; ++j) o[j] = fmaf(p, vr[j], o[j]);
    }
    float* dst = out + ((size_t)(b0 + t) * N + qi) * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH; j += 4)
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
  }
}

cudaError_t launch(const float* qkv, float* out, int batch,
                   cudaStream_t stream) {
  if (batch < 0 || ((uintptr_t)qkv & 15) || ((uintptr_t)out & 15))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (SHARED_BYTES > kDefaultShared) {
    static bool configured[kMaxDevices];
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!configured[dev]) {
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return err;
      if (SHARED_BYTES > (size_t)optin) return cudaErrorInvalidValue;
      err = cudaFuncSetAttribute(spin_attention_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)SHARED_BYTES);
      if (err != cudaSuccess) return err;
      configured[dev] = true;
    }
  }
  const int grid = (batch + IMAGES - 1) / IMAGES;
  spin_attention_kernel<<<grid, THREADS, SHARED_BYTES, stream>>>(qkv, out,
                                                                 batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [batch, n, heads·head_dim] = the attention of qkv [batch, n,
// 3·heads·head_dim] (each token row q | k | v, each heads × head_dim), per
// image and head.  Device pointers to contiguous float32, both 16-byte
// aligned; n, heads and head_dim must be the build's.  Launches on `stream`
// and does not synchronise.  Returns a cudaError_t (invalid value for a
// shape the kernel does not take).
int spin_attention_f32(const float* qkv, float* out, int batch, int n,
                       int heads, int head_dim, void* stream) {
  if (n != N || heads != NH || head_dim != DH)
    return (int)cudaErrorInvalidValue;
  return (int)launch(qkv, out, batch, (cudaStream_t)stream);
}

const char* spin_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
