// Flash-attention backward, dQ (causal or full, GQA) for Hopper, sm_90a.
//
// Replaces: the TPU kernel `_flash_bwd_dq_kernel`, launched by
// `_flash_attention_bwd_tpu` (move2kube_tpu/ops/attention.py). Its contract:
// for each query row, recompute p = exp(q.k^T * scale - lse) from the
// forward's logsumexp, then dp = dO.v^T, ds = p * (dp - delta) and
// dq = scale * sum_k ds.k, where delta = rowsum(dO * O) comes in from the
// caller (the JAX package computes it outside its kernels too). The causal
// mask compares absolute positions, as in the forward.
//
// What bounds it on an H100: operations. It does three products of the
// forward's size (q.k^T, dO.v^T, ds.k) under the mask against reading q, k,
// v, dO and writing dq once, well over 100 FLOPs per byte at the training
// slice's lengths, so the tensor cores' 989 TFLOP/s bf16 are the roofline.
// This first version computes with fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), as flash_fwd.cu does; mma/wgmma is later work.
//
// Design: the forward's layout. One block per (batch*head, 32-row query
// tile), 128 threads; four threads share one query row, each holding a
// quarter of its head_dim of q, dO and the fp32 dq accumulator in registers
// (96 floats at d=128). K/V tiles (64 keys in bf16, 32 in fp32: 32 KB for
// both at d=128) are staged in shared memory with 16-byte loads and read
// back as broadcasts. For a chunk of 2 keys the block first computes the
// scores and dO.v^T (partial dots summed with warp shuffles), then folds
// ds.k into the accumulator, reloading the chunk's K rows from shared
// memory (m2kt::reload_barrier) rather than keeping them in registers.
// Registers are the limit: the tile and chunk sizes were picked on an H100
// among 4 or 8 threads a row, 16 to 64 rows and chunks of 1 to 16 keys;
// larger chunks spill. The loop over key
// tiles ends at the block's causal frontier; tiles are scheduled longest
// first. Query head i reads KV head i / (h / kvh). Ragged query rows and
// key tails are masked here: a masked position has p = 0 and adds nothing,
// and rows past s are not written. No atomics: each dq row is written once
// by its own threads.
#include "common.cuh"

namespace {

constexpr int kBQ = 32;                       // query rows per block
constexpr int kLanesPerRow = 4;               // threads sharing one row
constexpr int kThreads = kBQ * kLanesPerRow;  // 128
constexpr int kKC = 2;                        // keys per chunk

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s, int sk, int h, int kvh, int causal, float scale) {
  constexpr int BK = 128 / sizeof(T);           // keys per shared tile
  constexpr int NC = D / (8 * kLanesPerRow);    // 8-wide chunks per thread
  constexpr int ROW_VECS = D * sizeof(T) / 16;  // 16-byte vectors per row
  static_assert(NC >= 1 && D % (8 * kLanesPerRow) == 0, "unsupported D");
  static_assert(BK % kKC == 0, "a tile holds whole chunks");
  __shared__ __align__(16) T k_tile[BK * D];
  __shared__ __align__(16) T v_tile[BK * D];

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int g = hi / (h / kvh);
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int row = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;
  const int qi = q_tile * kBQ + row;
  const bool q_valid = qi < s;

  float qr[NC * 8];
  float dor[NC * 8];
  float acc[NC * 8];
  const size_t row_off = ((size_t)(bi * s + qi) * h + hi) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d0 = (c * kLanesPerRow + lane) * 8;
    if (q_valid) {
      m2kt::load_vec<8>(q + row_off + d0, qr + c * 8);
      m2kt::load_vec<8>(dout + row_off + d0, dor + c * 8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[c * 8 + e] = dor[c * 8 + e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[c * 8 + e] = 0.f;
  }
  const float row_lse = q_valid ? lse[(size_t)bh * s + qi] : 0.f;
  const float row_delta = q_valid ? delta[(size_t)bh * s + qi] : 0.f;

  // keys at or past (q_tile + 1) * kBQ are masked for every row here
  const int n_keys = causal ? min(sk, (q_tile + 1) * kBQ) : sk;
  const size_t kv_row = (size_t)kvh * D;
  const T* k_base = k + ((size_t)bi * sk * kvh + g) * D;
  const T* v_base = v + ((size_t)bi * sk * kvh + g) * D;

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();  // the previous tile has been read by every thread
    for (int idx = threadIdx.x; idx < BK * ROW_VECS; idx += kThreads) {
      const int r = idx / ROW_VECS;
      const int c = idx % ROW_VECS;
      const int kj = k0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0);
      uint4 vv4 = make_uint4(0, 0, 0, 0);
      if (kj < sk) {
        kv4 = reinterpret_cast<const uint4*>(k_base + kj * kv_row)[c];
        vv4 = reinterpret_cast<const uint4*>(v_base + kj * kv_row)[c];
      }
      reinterpret_cast<uint4*>(k_tile + r * D)[c] = kv4;
      reinterpret_cast<uint4*>(v_tile + r * D)[c] = vv4;
    }
    __syncthreads();
    const int tile_keys = min(BK, n_keys - k0);
    for (int j0 = 0; j0 < tile_keys; j0 += kKC) {
      float ds[kKC];
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const T* k_row = k_tile + (j0 + j) * D;
        const T* v_row = v_tile + (j0 + j) * D;
        float ps = 0.f;
        float pd = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d0 = (c * kLanesPerRow + lane) * 8;
          float kf[8];
          float vf[8];
          m2kt::load_vec<8>(k_row + d0, kf);
          m2kt::load_vec<8>(v_row + d0, vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ps = fmaf(qr[c * 8 + e], kf[e], ps);
            pd = fmaf(dor[c * 8 + e], vf[e], pd);
          }
        }
#pragma unroll
        for (int o = 1; o < kLanesPerRow; o <<= 1) {
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
          pd += __shfl_xor_sync(0xffffffffu, pd, o);
        }
        const int kj = k0 + j0 + j;
        const bool ok = q_valid && kj < sk && (!causal || kj <= qi);
        const float p = ok ? expf(ps * scale - row_lse) : 0.f;
        ds[j] = p * (pd - row_delta);
      }
      m2kt::reload_barrier();
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const T* k_row = k_tile + (j0 + j) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float kf[8];
          m2kt::load_vec<8>(k_row + (c * kLanesPerRow + lane) * 8, kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[c * 8 + e] = fmaf(ds[j], kf[e], acc[c * 8 + e]);
          }
        }
      }
    }
  }

  if (q_valid) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = acc[c * 8 + e] * scale;
      m2kt::store_vec<8>(dq + row_off + (c * kLanesPerRow + lane) * 8, out);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int b, int s, int sk, int h, int kvh, int d,
                   int causal, float scale, cudaStream_t stream) {
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dqp = static_cast<T*>(dq);
  switch (d) {
    case 64:
      flash_bwd_dq_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, dop, lse, delta, dqp, s, sk, h, kvh, causal, scale);
      break;
    case 128:
      flash_bwd_dq_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, dop, lse, delta, dqp, s, sk, h, kvh, causal, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

M2KT_EXPORT_ERROR_STRING

// q/dout/dq [b, s, h, d], k/v [b, sk, kvh, d] of one type (dtype: 0 fp32,
// 1 bf16); lse and delta fp32 [b, h, s]; all contiguous. Launches on
// `stream` of `device` and returns cudaGetLastError().
extern "C" int m2kt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int s,
                                 int sk, int h, int kvh, int d, int causal,
                                 float scale, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  if (dtype == m2kt::kFloat32) {
    err = launch<float>(q, k, v, dout, lp, dp, dq, b, s, sk, h, kvh, d,
                        causal, scale, st);
  } else if (dtype == m2kt::kBFloat16) {
    err = launch<__nv_bfloat16>(q, k, v, dout, lp, dp, dq, b, s, sk, h, kvh,
                                d, causal, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
