// One-token GQA decode attention over an int8 paged KV cache, for Hopper
// sm_90a.
//
// Replaces: the TPU kernel `_paged_decode_packed_kernel` with
// `quantized=True`, launched by `_paged_decode_packed`
// (move2kube_tpu/ops/attention.py). Its fp branch has the contract of
// `_paged_decode_kernel`, which csrc/paged_decode.cu serves.
//
// Contract: q [b, h, d] fp32 or bf16; k_pages/v_pages [num_pages,
// block_size, kvh, d] int8; k_scale/v_scale [num_pages, block_size, kvh]
// fp32, one scale per written (token, kv-head) row; o [b, h, d] in q's
// type. The scales are folded in after the contractions, as in the TPU
// kernel (attention.py, the `quantized` branches of `_tile`):
//   score = ((q * scale) . k8) * k_scale
//   l    += p                        (no v_scale)
//   acc  += (p * v_scale) * v8
//   o     = acc / l
// so no dequantized context exists anywhere, not even in registers.
//
// What bounds it on an H100: bytes. A live context token costs
// 2 * kvh * (d + 4) bytes (int8 K and V rows plus their fp32 scales),
// 0.52x the bf16 kernel's 2 * kvh * 2d at d = 128, read once and used for
// a handful of FLOPs per byte; 3.35 TB/s of device memory is the roofline.
//
// Design: csrc/paged_decode.cu's, with int8 rows. One block per (KV head,
// sequence), 8 warps, serving that KV head's rep = h / kvh query heads.
// The TPU kernel packs `pages_per_tile` pages into one VMEM tile because
// the int8 minimum tile is 32 sublanes and a page holds 8-16 rows; there
// is no such minimum here, and the unit of work is a warp's group of 8
// consecutive tokens (never straddling a page, as block_size % 8 == 0),
// so the packing and its tuning sweep have no counterpart. Warp w takes
// groups w, w + 8, ..., each with its own online-softmax state per query
// head, and the eight states are merged through shared memory at the end.
// A lane holds d / 32 consecutive values of each row: at d = 128 one
// 32-bit load of 4 int8 values, so a row is one 128-byte warp load (at
// d = 64, 16 bits and 64 bytes). The 8 K and 8 V rows of a group and their
// 16 scales (lane-uniform loads, one fp32 each) are issued before any
// arithmetic, to keep bytes in flight. The block walks its own
// block-table row and touches only pages below ceil(seq_len /
// block_size): the null page behind unused entries is never read. Rows
// past seq_len inside the last page are masked by selecting -1e30 for
// their scores and skipping their V rows, so stale values there (or a NaN
// scale) cannot reach the result.
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

// N (2 or 4) consecutive int8 values as fp32, in one 16- or 32-bit load.
template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, float* out) {
  if constexpr (N == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
    static_assert(N == 2, "load_i8: N must be 2 or 4");
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x; out[1] = c.y;
  }
}

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_int8_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ k_pages,
                         const int8_t* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ seq_lens, T* __restrict__ o,
                         int h, int kvh, int block_size, int max_blocks,
                         float scale) {
  constexpr int E = D / 32;  // values of a row per lane
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
  const size_t page_rows = (size_t)block_size * kvh;  // scale rows a page
  const int n_groups = (n_tok + kGroup - 1) / kGroup;
  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int base = grp * kGroup;
    const size_t page = static_cast<size_t>(bt[base / block_size]);
    // (token, kv head) row index of this group's first token
    const size_t srow0 = page * page_rows + (base % block_size) * kvh + g;
    const size_t row0 = srow0 * D + lane * E;
    float kf[kGroup][E];
    float vf[kGroup][E];
    float ks[kGroup];
    float vs[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      load_i8<E>(k_pages + row0 + t * tok_stride, kf[t]);
    }
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      load_i8<E>(v_pages + row0 + t * tok_stride, vf[t]);
    }
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      ks[t] = k_scale[srow0 + t * kvh];
      vs[t] = v_scale[srow0 + t * kvh];
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
        part = warp_sum(part) * ks[t];
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
          const float pv = p * vs[t];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[r][e] = fmaf(pv, vf[t][e], acc[r][e]);
          }
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

struct Args {
  const void* q;
  const int8_t* kp;
  const int8_t* vp;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* sl;
  void* o;
  int b, h, kvh, block_size, max_blocks;
  float scale;
};

template <typename T, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.kvh, a.b);
  const T* qq = static_cast<const T*>(a.q);
  T* oo = static_cast<T*>(a.o);
#define M2KT_PAGED_CASE(R)                                                   \
  case R:                                                                    \
    paged_decode_int8_kernel<T, D, R><<<grid, kWarps * 32, 0, stream>>>(     \
        qq, a.kp, a.vp, a.ks, a.vs, a.bt, a.sl, oo, a.h, a.kvh,              \
        a.block_size, a.max_blocks, a.scale);                                \
    break;
  switch (a.h / a.kvh) {
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
cudaError_t launch(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_d<T, 64>(a, stream);
    case 128:
      return launch_d<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

M2KT_EXPORT_ERROR_STRING

// q [b, h, d] and o [b, h, d] of one type (dtype: 0 fp32, 1 bf16);
// k_pages/v_pages [num_pages, block_size, kvh, d] int8, 16-byte aligned;
// k_scale/v_scale [num_pages, block_size, kvh] fp32; block_tables
// [b, max_blocks] and seq_lens [b] int32; all contiguous. block_size % 8
// == 0, h / kvh in {1, 2, 4, 8}, d in {64, 128}. Launches on `stream` of
// `device` and returns cudaGetLastError().
extern "C" int m2kt_paged_decode_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* seq_lens, void* o, int b, int h, int kvh, int d,
    int block_size, int max_blocks, float scale, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_size % kGroup != 0 || kvh <= 0 || h % kvh != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,
               static_cast<const int8_t*>(k_pages),
               static_cast<const int8_t*>(v_pages),
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens),
               o,
               b,
               h,
               kvh,
               block_size,
               max_blocks,
               scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == m2kt::kFloat32) {
    err = launch<float>(a, d, st);
  } else if (dtype == m2kt::kBFloat16) {
    err = launch<__nv_bfloat16>(a, d, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
