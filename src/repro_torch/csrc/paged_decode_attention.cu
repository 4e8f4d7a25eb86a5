// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_decode_attention.py::
// paged_decode_attention_kernel (the Pallas TPU kernel). Same function:
// for row b and query head h, softmax(q . K^T * dh^-0.5) . V over the
// row's first lengths[b] cache entries, where logical page j of row b is
// physical page pages[b, j] of pools shaped (n_pages, page_size, Hkv, dh)
// and kv head = h / G. Masks: kpos < length, (qpos - kpos) < window,
// qpos / chunk == kpos / chunk, with qpos = length - 1. Online softmax in
// float32; the output is acc / max(l, 1e-30) in q's dtype, so a row with
// length 0 gets zeros.
//
// Bound: bytes. Each live K/V page is read once and used for ~4 * G
// flops per byte pair, far below the card's ~295 flop/byte balance, so
// the least time is the live pages' bytes over HBM bandwidth.
//
// Design: one CTA per (row, kv head) and one warp per query head of its
// group of G, so each page is read from device memory once for all G
// heads (the Pallas grid (B, Hq, P) reads it G times). The CTA stages a
// page's K and V rows for its kv head in shared memory with 16-byte
// loads; each warp keeps its query row, running max, sum and accumulator
// in registers (lane i owns elements i, i+32, ...). The masks reduce to
// one contiguous key range [lo, length), so pages wholly outside it are
// never loaded. A simple first kernel: no cp.async/TMA double-buffering
// and no split-K over pages yet.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the Python wrapper raises on anything else
// than cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerLane = 8;  // dh <= 32 * kMaxPerLane = 256
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void paged_decode_attention_kernel(
    const T* __restrict__ q,              // (B, Hq, dh)
    const T* __restrict__ k_pool,         // (n_pages, ps, Hkv, dh)
    const T* __restrict__ v_pool,         // (n_pages, ps, Hkv, dh)
    const int32_t* __restrict__ pages,    // (B, P)
    const int32_t* __restrict__ lengths,  // (B,)
    T* __restrict__ out,                  // (B, Hq, dh)
    int Hkv, int G, int dh, int ps, int P, int window, int chunk,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);  // (ps, dh) K rows of one page
  T* v_s = k_s + ps * dh;               // (ps, dh) V rows of one page

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int head = h * G + warp;
  const int Hq = Hkv * G;
  const int length = lengths[b];
  const int qpos = length - 1;

  float qr[kMaxPerLane], acc[kMaxPerLane];
  const T* qrow = q + (static_cast<size_t>(b) * Hq + head) * dh;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    qr[i] = e < dh ? to_f32(qrow[e]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  // every mask is a lower bound on kpos, so the visible keys are [lo, length)
  int lo = 0;
  if (window > 0) lo = max(lo, qpos - window + 1);
  if (chunk > 0 && qpos >= 0) lo = max(lo, (qpos / chunk) * chunk);
  const int pg_end = length > 0 ? min((length + ps - 1) / ps, P) : 0;
  const int pg_begin = lo / ps;

  // 16-byte vectors: a page's rows for head h are ps runs of dh elements,
  // Hkv * dh elements apart in the pool
  const int row_vec = dh * static_cast<int>(sizeof(T)) / 16;
  const int page_vec = ps * row_vec;
  const size_t stride_vec = static_cast<size_t>(Hkv) * row_vec;
  const uint4* kg = reinterpret_cast<const uint4*>(k_pool);
  const uint4* vg = reinterpret_cast<const uint4*>(v_pool);
  uint4* ks4 = reinterpret_cast<uint4*>(k_s);
  uint4* vs4 = reinterpret_cast<uint4*>(v_s);

  for (int j = pg_begin; j < pg_end; ++j) {
    const size_t page = static_cast<size_t>(pages[b * P + j]);
    const size_t base = (page * ps * Hkv + h) * row_vec;
    __syncthreads();  // the previous page is no longer read
    for (int i = threadIdx.x; i < page_vec; i += blockDim.x) {
      const int t = i / row_vec, c = i - t * row_vec;
      const size_t src = base + t * stride_vec + c;
      ks4[i] = kg[src];
      vs4[i] = vg[src];
    }
    __syncthreads();
    const int t_lo = max(0, lo - j * ps);
    const int t_hi = min(ps, length - j * ps);
    for (int t = t_lo; t < t_hi; ++t) {
      const T* kr = k_s + t * dh;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int e = lane + 32 * i;
        if (e < dh) part += qr[i] * to_f32(kr[e]);
      }
      const float s = warp_sum(part);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
      const T* vr = v_s + t * dh;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int e = lane + 32 * i;
        if (e < dh) acc[i] = acc[i] * alpha + p * to_f32(vr[e]);
      }
      m = m_new;
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + (static_cast<size_t>(b) * Hq + head) * dh;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < dh) store(orow + e, acc[i] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* pages, const void* lengths, void* out, int B,
                   int Hkv, int G, int dh, int ps, int P, int window,
                   int chunk, float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(ps) * dh * sizeof(T);
  paged_decode_attention_kernel<T><<<B * Hkv, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(pages),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), Hkv, G, dh,
      ps, P, window, chunk, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window / chunk: 0 = no such mask.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* pages, const void* lengths, void* out, int B, int Hkv, int G,
    int dh, int ps, int P, int window, int chunk, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, pages, lengths, out, B, Hkv, G,
                         dh, ps, P, window, chunk, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, pages, lengths, out, B,
                                 Hkv, G, dh, ps, P, window, chunk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
