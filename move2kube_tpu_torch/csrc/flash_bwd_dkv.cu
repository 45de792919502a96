// Flash-attention backward, dK and dV (causal or full, GQA) for Hopper,
// sm_90a.
//
// Replaces: the TPU kernel `_flash_bwd_dkv_kernel`, launched by
// `_flash_attention_bwd_tpu` (move2kube_tpu/ops/attention.py). Its contract:
// for each key row, scan the query rows that can see it, recompute
// p = exp(q.k^T * scale - lse), and accumulate dv = sum_q p^T.dO and
// dk = scale * sum_q ds^T.q with ds = p * (dO.v^T - delta); delta =
// rowsum(dO * O) comes in from the caller. Under the causal mask the scan
// starts at the query tile that holds the key tile's first row, as the TPU
// kernel's does.
//
// GQA: the JAX model repeats K/V up to the query heads before attention,
// and jnp.repeat's VJP sums dk/dv over each group. This kernel takes K/V at
// kvh heads, as the forward does, and returns dk/dv at kvh heads holding
// that sum: a block owns one (batch, KV head, 32-key tile) and loops over
// the h / kvh query heads of its group. Each dk/dv row is written once, by
// the threads that own it: no atomics, and the same result every run.
//
// What bounds it on an H100: operations. It does four products of the
// forward's size (q.k^T, dO.v^T, p^T.dO, ds^T.q) under the mask against
// reading q, k, v, dO and writing dk, dv once, so the tensor cores' 989
// TFLOP/s bf16 are the roofline. This first version computes with fp32 FMAs
// on the CUDA cores (67 TFLOP/s peak), as flash_fwd.cu does; mma/wgmma is
// later work.
//
// Design: the forward's layout, transposed. 128 threads; four threads
// share one key row, each holding a quarter of its head_dim of k, v and of
// the two fp32 accumulators in registers (128 floats at d=128). Query tiles
// of q and dO (64 rows in bf16, 32 in fp32: 32 KB for both at d=128) with
// their lse and delta are staged in shared memory and read back as
// broadcasts. One query at a time, the block computes the score and
// dO.v^T (partial dots summed with warp shuffles), then folds p.dO into dv
// and ds.q into dk, reloading the query's q and dO rows from shared memory
// (m2kt::reload_barrier) rather than keeping them in registers. Registers
// are this kernel's limit: the tile and chunk sizes were picked on an H100
// among 4 or 8 threads a row, 16 to 64 rows and chunks of 1 to 8 queries;
// chunks of 8 spilled 2 KB a thread and ran 5.8x slower. Key tiles are scheduled first to last, which under the
// causal mask is longest first. Ragged key rows and query tails are masked
// here: a masked position has p = 0 and adds nothing, and key rows past sk
// are not written.
#include "common.cuh"

namespace {

constexpr int kBK = 32;                       // key rows per block
constexpr int kLanesPerRow = 4;               // threads sharing one row
constexpr int kThreads = kBK * kLanesPerRow;  // 128
constexpr int kQC = 1;                        // queries per chunk

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int s, int sk, int h, int kvh,
                     int causal, float scale) {
  constexpr int BQ = 128 / sizeof(T);           // query rows per shared tile
  constexpr int NC = D / (8 * kLanesPerRow);    // 8-wide chunks per thread
  constexpr int ROW_VECS = D * sizeof(T) / 16;  // 16-byte vectors per row
  static_assert(NC >= 1 && D % (8 * kLanesPerRow) == 0, "unsupported D");
  static_assert(BQ % kQC == 0, "a tile holds whole chunks");
  __shared__ __align__(16) T q_tile[BQ * D];
  __shared__ __align__(16) T do_tile[BQ * D];
  __shared__ float lse_tile[BQ];
  __shared__ float delta_tile[BQ];

  const int bg = blockIdx.x;
  const int bi = bg / kvh;
  const int g = bg % kvh;
  const int rep = h / kvh;
  const int k_first = blockIdx.y * kBK;
  const int row = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;
  const int kj = k_first + row;
  const bool k_valid = kj < sk;

  float kr[NC * 8];
  float vr[NC * 8];
  float dk_acc[NC * 8];
  float dv_acc[NC * 8];
  const size_t kv_off = ((size_t)(bi * sk + kj) * kvh + g) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d0 = (c * kLanesPerRow + lane) * 8;
    if (k_valid) {
      m2kt::load_vec<8>(k + kv_off + d0, kr + c * 8);
      m2kt::load_vec<8>(v + kv_off + d0, vr + c * 8);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kr[c * 8 + e] = vr[c * 8 + e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dk_acc[c * 8 + e] = dv_acc[c * 8 + e] = 0.f;
  }

  // query rows before k_first see none of this tile's keys
  const int q_begin = causal ? (k_first / BQ) * BQ : 0;
  const size_t q_stride = (size_t)h * D;

  for (int r = 0; r < rep; ++r) {
    const int hi = g * rep + r;
    const T* q_base = q + ((size_t)bi * s * h + hi) * D;
    const T* do_base = dout + ((size_t)bi * s * h + hi) * D;
    const float* lse_base = lse + ((size_t)bi * h + hi) * s;
    const float* delta_base = delta + ((size_t)bi * h + hi) * s;
    for (int q0 = q_begin; q0 < s; q0 += BQ) {
      __syncthreads();  // the previous tile has been read by every thread
      for (int idx = threadIdx.x; idx < BQ * ROW_VECS; idx += kThreads) {
        const int rr = idx / ROW_VECS;
        const int c = idx % ROW_VECS;
        const int qi = q0 + rr;
        uint4 q4 = make_uint4(0, 0, 0, 0);
        uint4 d4 = make_uint4(0, 0, 0, 0);
        if (qi < s) {
          q4 = reinterpret_cast<const uint4*>(q_base + qi * q_stride)[c];
          d4 = reinterpret_cast<const uint4*>(do_base + qi * q_stride)[c];
        }
        reinterpret_cast<uint4*>(q_tile + rr * D)[c] = q4;
        reinterpret_cast<uint4*>(do_tile + rr * D)[c] = d4;
      }
      for (int rr = threadIdx.x; rr < BQ; rr += kThreads) {
        const int qi = q0 + rr;
        lse_tile[rr] = qi < s ? lse_base[qi] : 0.f;
        delta_tile[rr] = qi < s ? delta_base[qi] : 0.f;
      }
      __syncthreads();
      const int tile_q = min(BQ, s - q0);
      for (int j0 = 0; j0 < tile_q; j0 += kQC) {
        float pc[kQC];
        float ds[kQC];
#pragma unroll
        for (int j = 0; j < kQC; ++j) {
          const T* q_row = q_tile + (j0 + j) * D;
          const T* do_row = do_tile + (j0 + j) * D;
          float ps = 0.f;
          float pd = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int d0 = (c * kLanesPerRow + lane) * 8;
            float qf[8];
            float df[8];
            m2kt::load_vec<8>(q_row + d0, qf);
            m2kt::load_vec<8>(do_row + d0, df);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              ps = fmaf(qf[e], kr[c * 8 + e], ps);
              pd = fmaf(df[e], vr[c * 8 + e], pd);
            }
          }
#pragma unroll
          for (int o = 1; o < kLanesPerRow; o <<= 1) {
            ps += __shfl_xor_sync(0xffffffffu, ps, o);
            pd += __shfl_xor_sync(0xffffffffu, pd, o);
          }
          const int qi = q0 + j0 + j;
          const bool ok = k_valid && qi < s && (!causal || kj <= qi);
          const float p = ok ? expf(ps * scale - lse_tile[j0 + j]) : 0.f;
          pc[j] = p;
          ds[j] = p * (pd - delta_tile[j0 + j]);
        }
        m2kt::reload_barrier();
#pragma unroll
        for (int j = 0; j < kQC; ++j) {
          const T* q_row = q_tile + (j0 + j) * D;
          const T* do_row = do_tile + (j0 + j) * D;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int d0 = (c * kLanesPerRow + lane) * 8;
            float qf[8];
            float df[8];
            m2kt::load_vec<8>(q_row + d0, qf);
            m2kt::load_vec<8>(do_row + d0, df);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              dk_acc[c * 8 + e] = fmaf(ds[j], qf[e], dk_acc[c * 8 + e]);
              dv_acc[c * 8 + e] = fmaf(pc[j], df[e], dv_acc[c * 8 + e]);
            }
          }
        }
      }
    }
  }

  if (k_valid) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = (c * kLanesPerRow + lane) * 8;
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = dk_acc[c * 8 + e] * scale;
      m2kt::store_vec<8>(dk + kv_off + d0, out);
      m2kt::store_vec<8>(dv + kv_off + d0, dv_acc + c * 8);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int b, int s, int sk, int h, int kvh,
                   int d, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(b * kvh, (sk + kBK - 1) / kBK);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  switch (d) {
    case 64:
      flash_bwd_dkv_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, dop, lse, delta, dkp, dvp, s, sk, h, kvh, causal,
          scale);
      break;
    case 128:
      flash_bwd_dkv_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, dop, lse, delta, dkp, dvp, s, sk, h, kvh, causal,
          scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

M2KT_EXPORT_ERROR_STRING

// q/dout [b, s, h, d], k/v/dk/dv [b, sk, kvh, d] of one type (dtype: 0
// fp32, 1 bf16); lse and delta fp32 [b, h, s]; all contiguous. Launches on
// `stream` of `device` and returns cudaGetLastError().
extern "C" int m2kt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int b, int s, int sk,
                                  int h, int kvh, int d, int causal,
                                  float scale, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  if (dtype == m2kt::kFloat32) {
    err = launch<float>(q, k, v, dout, lp, dp, dk, dv, b, s, sk, h, kvh, d,
                        causal, scale, st);
  } else if (dtype == m2kt::kBFloat16) {
    err = launch<__nv_bfloat16>(q, k, v, dout, lp, dp, dk, dv, b, s, sk, h,
                                kvh, d, causal, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
