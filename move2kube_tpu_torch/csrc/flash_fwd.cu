// Flash-attention forward (causal or full, GQA) for Hopper, sm_90a.
//
// Replaces: the TPU kernel `_flash_kernel`, launched by
// `_flash_attention_tpu` (move2kube_tpu/ops/attention.py). Like it, the
// kernel optionally writes each row's logsumexp, which the backward kernels
// (flash_bwd_dq.cu, flash_bwd_dkv.cu) read to recompute the probabilities:
// fp32, laid out [b, h, s] (the TPU kernel broadcasts it over 128 lanes),
// lse = m + log(max(l, 1e-30)) in the units of the scaled scores.
//
// What bounds it on an H100: operations. Causal attention does about
// 2*b*h*s^2*d FLOPs against (q + k + v + o) bytes, over 100 FLOPs per byte
// at the slice's prefill lengths, so the tensor cores' 989 TFLOP/s bf16 are
// the roofline. This first version computes with fp32 FMAs on the CUDA
// cores (67 TFLOP/s peak), so it sits well below that bound; mma/wgmma is
// later work.
//
// Design: one block per (batch*head, 64-row query tile), 256 threads. Four
// threads share one query row, each holding a quarter of its head_dim for
// q and for the fp32 output accumulator in registers; a score is their
// partial dots summed with two warp shuffles. K/V tiles (64 keys in bf16,
// 32 in fp32: 32 KB for both at d=128) are staged in shared memory with
// 16-byte loads and read back as broadcasts. The TPU kernel's fori_loop
// over K blocks is the loop over tiles here, ending at the block's causal
// frontier. Online softmax runs in chunks of 16 keys: one rescale of the
// accumulator per chunk instead of per key. Query head i reads KV head
// i / (h / kvh), the order jnp.repeat(k, rep, axis=2) gives. Ragged query
// and key tails are masked here, so any s and sk are taken. Query tiles
// are scheduled from the last (longest under the causal mask) to the
// first.
#include "common.cuh"

namespace {

using m2kt::kNegInf;

constexpr int kBQ = 64;                       // query rows per block
constexpr int kLanesPerRow = 4;               // threads sharing one row
constexpr int kThreads = kBQ * kLanesPerRow;  // 256
constexpr int kKC = 16;                       // keys per softmax chunk

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int sk, int h, int kvh,
                 int causal, float scale) {
  constexpr int BK = 128 / sizeof(T);           // keys per shared tile
  constexpr int NC = D / (8 * kLanesPerRow);    // 8-wide chunks per thread
  constexpr int ROW_VECS = D * sizeof(T) / 16;  // 16-byte vectors per row
  static_assert(NC >= 1 && D % (8 * kLanesPerRow) == 0, "unsupported D");
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
  float acc[NC * 8];
  const T* q_row = q + ((size_t)(bi * s + qi) * h + hi) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d0 = (c * kLanesPerRow + lane) * 8;
    if (q_valid) {
      m2kt::load_vec<8>(q_row + d0, qr + c * 8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[c * 8 + e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[c * 8 + e] *= scale;
      acc[c * 8 + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

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
      float sc[kKC];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const T* k_row = k_tile + (j0 + j) * D;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float kf[8];
          m2kt::load_vec<8>(k_row + (c * kLanesPerRow + lane) * 8, kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) part = fmaf(qr[c * 8 + e], kf[e], part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int kj = k0 + j0 + j;
        const bool ok = kj < sk && (!causal || kj <= qi);
        sc[j] = ok ? part : kNegInf;
        cmax = fmaxf(cmax, sc[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        sc[j] = sc[j] == kNegInf ? 0.f : expf(sc[j] - m_new);
        psum += sc[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < NC * 8; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const T* v_row = v_tile + (j0 + j) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float vf[8];
          m2kt::load_vec<8>(v_row + (c * kLanesPerRow + lane) * 8, vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[c * 8 + e] = fmaf(sc[j], vf[e], acc[c * 8 + e]);
          }
        }
      }
      m = m_new;
    }
  }

  if (q_valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o_row = o + ((size_t)(bi * s + qi) * h + hi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = acc[c * 8 + e] * inv;
      m2kt::store_vec<8>(o_row + (c * kLanesPerRow + lane) * 8, out);
    }
    // m and l are the same in the four lanes of a row
    if (lse != nullptr && lane == 0) {
      lse[(size_t)bh * s + qi] = m + logf(fmaxf(l, 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int s, int sk, int h, int kvh, int d,
                   int causal, float scale, cudaStream_t stream) {
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (d) {
    case 64:
      flash_fwd_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, lse, s, sk, h, kvh, causal, scale);
      break;
    case 128:
      flash_fwd_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, lse, s, sk, h, kvh, causal, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

M2KT_EXPORT_ERROR_STRING

// q [b, s, h, d], k/v [b, sk, kvh, d], o [b, s, h, d]; all contiguous, of
// one type (dtype: 0 fp32, 1 bf16). lse is fp32 [b, h, s], or null when the
// caller does not want it. Launches on `stream` of `device` and returns
// cudaGetLastError().
extern "C" int m2kt_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int s, int sk, int h,
                              int kvh, int d, int causal, float scale,
                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == m2kt::kFloat32) {
    err = launch<float>(q, k, v, o, static_cast<float*>(lse), b, s, sk, h,
                        kvh, d, causal, scale, st);
  } else if (dtype == m2kt::kBFloat16) {
    err = launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), b, s,
                                sk, h, kvh, d, causal, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
