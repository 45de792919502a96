// One-token GQA decode attention over a paged KV cache, for Hopper sm_90a.
//
// Replaces: the TPU kernel `_paged_decode_kernel`, launched by
// `_paged_decode_tpu` (move2kube_tpu/ops/attention.py), for fp32/bf16 page
// pools. The int8 pools (`_paged_decode_packed_kernel`) come with the
// int8-KV serving slice.
//
// What bounds it on an H100: bytes. Each live context token's K and V rows
// are read once and used for a handful of FLOPs per byte (rep query heads
// share them), so the 3.35 TB/s of device memory is the roofline:
// sum_b seq_len_b * kvh * d * 2 (K and V) * sizeof(T), plus q and o.
//
// Design: one block per (KV head, sequence), 8 warps, serving that KV
// head's rep = h / kvh query heads. The TPU grid's sequential page axis,
// with acc/m/l carried across grid steps in scratch, becomes a split over
// warps inside the block: warp w takes groups of 8 consecutive tokens
// w, w + 8, ..., each with its own online-softmax state, and the eight
// states are merged through shared memory at the end. A group never
// straddles a page (block_size % 8 == 0), so the block reads its own
// block-table row and touches only pages below ceil(seq_len / block_size);
// the null page behind unused table entries is never read. Every lane
// holds d / 32 contiguous elements of each query head and of its fp32
// accumulator, so one token's K or V row is one coalesced warp load and
// a score is a five-step shuffle reduction. All 16 K and V row loads of a
// group are issued before any arithmetic, to keep bytes in flight. Rows
// past seq_len inside the last page are masked, and their V rows are not
// used (they may hold stale values).
#include "common.cuh"

namespace {

using m2kt::kNegInf;

constexpr int kWarps = 8;
constexpr int kGroup = 8;  // consecutive tokens a warp takes at a time

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ o,
                    int h, int kvh, int block_size, int max_blocks,
                    float scale) {
  constexpr int E = D / 32;  // elements of a row per lane
  static_assert(E == 2 || E == 4, "unsupported D");
  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][REP][D];

  const int g = blockIdx.x;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tok = min(seq_lens[bi], max_blocks * block_size);
  const int* bt = block_tables + (size_t)bi * max_blocks;

  float qr[REP][E];
  float acc[REP][E];
  float m[REP];
  float l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const T* q_row = q + ((size_t)bi * h + g * REP + r) * D + lane * E;
    m2kt::load_vec<E>(q_row, qr[r]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[r][e] *= scale;
      acc[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const size_t tok_stride = (size_t)kvh * D;
  const size_t page_stride = (size_t)block_size * tok_stride;
  const int n_groups = (n_tok + kGroup - 1) / kGroup;
  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int base = grp * kGroup;
    const size_t page = static_cast<size_t>(bt[base / block_size]);
    const size_t row0 =
        page * page_stride + (base % block_size) * tok_stride + g * D +
        lane * E;
    float kf[kGroup][E];
    float vf[kGroup][E];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      m2kt::load_vec<E>(k_pages + row0 + t * tok_stride, kf[t]);
    }
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      m2kt::load_vec<E>(v_pages + row0 + t * tok_stride, vf[t]);
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float sc[kGroup];
      float gmax = kNegInf;
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[r][e], kf[t][e], part);
        part = warp_sum(part);
        sc[t] = base + t < n_tok ? part : kNegInf;
        gmax = fmaxf(gmax, sc[t]);
      }
      const float m_new = fmaxf(m[r], gmax);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        if (base + t < n_tok) {
          const float p = expf(sc[t] - m_new);
          psum += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[t][e], acc[r][e]);
        }
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < REP * D; idx += kWarps * 32) {
    const int r = idx / D;
    const int di = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f;
    float out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * c;
      out += sm_acc[w][r][di] * c;
    }
    m2kt::store_one(o + ((size_t)bi * h + g * REP + r) * D + di,
                    out / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const int* bt, const int* sl, void* o, int b, int h,
                     int kvh, int block_size, int max_blocks, float scale,
                     cudaStream_t stream) {
  const dim3 grid(kvh, b);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(kp);
  const T* vv = static_cast<const T*>(vp);
  T* oo = static_cast<T*>(o);
#define M2KT_PAGED_CASE(R)                                                   \
  case R:                                                                    \
    paged_decode_kernel<T, D, R><<<grid, kWarps * 32, 0, stream>>>(          \
        qq, kk, vv, bt, sl, oo, h, kvh, block_size, max_blocks, scale);      \
    break;
  switch (h / kvh) {
    M2KT_PAGED_CASE(1)
    M2KT_PAGED_CASE(2)
    M2KT_PAGED_CASE(4)
    M2KT_PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef M2KT_PAGED_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* sl, void* o, int b, int h,
                   int kvh, int d, int block_size, int max_blocks,
                   float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_d<T, 64>(q, kp, vp, bt, sl, o, b, h, kvh, block_size,
                             max_blocks, scale, stream);
    case 128:
      return launch_d<T, 128>(q, kp, vp, bt, sl, o, b, h, kvh, block_size,
                              max_blocks, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

M2KT_EXPORT_ERROR_STRING

// q [b, h, d]; k_pages/v_pages [num_pages, block_size, kvh, d]; o [b, h, d]
// of one type (dtype: 0 fp32, 1 bf16); block_tables [b, max_blocks] and
// seq_lens [b] int32; all contiguous. block_size % 8 == 0. Launches on
// `stream` of `device` and returns cudaGetLastError().
extern "C" int m2kt_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages,
                                 const void* block_tables,
                                 const void* seq_lens, void* o, int b, int h,
                                 int kvh, int d, int block_size,
                                 int max_blocks, float scale, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_size % kGroup != 0 || kvh <= 0 || h % kvh != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  if (dtype == m2kt::kFloat32) {
    err = launch<float>(q, k_pages, v_pages, bt, sl, o, b, h, kvh, d,
                        block_size, max_blocks, scale, st);
  } else if (dtype == m2kt::kBFloat16) {
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, bt, sl, o, b, h, kvh, d,
                                block_size, max_blocks, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
