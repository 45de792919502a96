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
//
// bf16 inputs take the tensor-core kernel (`tc::flash_bwd_dq_tc`), with
// the TPU kernel's MXU numerics: bf16 operands, fp32 sums, ds computed in
// fp32 and rounded to bf16 for ds.k. It has flash_fwd.cu's layout: one
// block per (batch*head, 128 query rows), two consumer warpgroups of 64
// rows each holding their dQ accumulator in registers, and one producer
// warp whose first thread issues every TMA load: the block's Q and dO
// rows once, then 64-key K/V tiles into a 2-stage ring of full and empty
// `mbarrier`s, up to the block's causal frontier. Per tile, S = Q.K^T and
// dP = dO.V^T are `wgmma` products with both operands in shared memory
// (K-major); P = exp2(S scale log2e - lse log2e) and dS = P (dP - delta)
// run on the accumulator fragments with each row's lse and delta in
// registers; dQ += dS.K is a `wgmma` with the rounded fragment as A in
// registers and K read MN-major. Keys come 64 to a tile so that dQ (64
// floats a thread at d=128) and the S and dP fragments (32 each) fit the
// 168 registers ptxas allows a thread of this 288-thread kernel. Only the
// causal diagonal and a ragged key tail are masked; query rows past s
// read zeros in Q and dO, take lse = +inf (so p = 0) and are clipped by
// the TMA store of dQ, which goes through the warpgroup's own Q rows in
// shared memory after one scaling.
//
// fp32 inputs take the CUDA-core kernel (`flash_bwd_dq_kernel`), whose
// fp32 FMAs keep the JAX package's fp32 contract (no TF32): one block per
// (batch*head, 32-row query tile), 128 threads; four threads share one
// query row, each holding a quarter of its head_dim of q, dO and the fp32
// dq accumulator in registers (96 floats at d=128). K/V tiles (32 keys:
// 32 KB for both at d=128) are staged in shared memory with 16-byte loads
// and read back as broadcasts. For a chunk of 2 keys the block first
// computes the scores and dO.v^T (partial dots summed with warp shuffles),
// then folds ds.k into the accumulator, reloading the chunk's K rows from
// shared memory (m2kt::reload_barrier) rather than keeping them in
// registers. Registers are the limit: the tile and chunk sizes were picked
// on an H100 among 4 or 8 threads a row, 16 to 64 rows and chunks of 1 to
// 16 keys; larger chunks spill. Ragged query rows and key tails are masked
// here: a masked position has p = 0 and adds nothing.
//
// Both kernels end the key loop at the block's causal frontier and
// schedule query tiles longest first; query head i reads KV head
// i / (h / kvh); rows past s are not written. No atomics: each dq row is
// written once by its own threads.
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16: warp-specialised tensor-core kernel (wgmma fed by TMA)
// ---------------------------------------------------------------------------

namespace tc {

using namespace m2kt::hopper;

constexpr int kBQ = 128;      // query rows per block: 64 per consumer
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kStages = 2;    // K/V tiles in flight
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;     // + one producer warp

// Shared memory of one block, in bytes from a 1024-byte aligned base: the
// block's Q and dO rows, a ring of K and V tiles, the barriers (q, full,
// empty).
template <int D>
struct Smem {
  static constexpr int kChunks = D / 64;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_dq,
                const float* __restrict__ lse,
                const float* __restrict__ delta, int s, int sk, int h,
                int kvh, int causal, float scale, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int g = hi / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // keys at or past q0 + kBQ are masked for every row of the block
  const int n_keys = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: one thread issues every copy
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, 2 * L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c) {
        const uint32_t off = c * kBQ * kRowBytes;
        tma_load(base + L::kQ + off, &tm_q, bar_q, c * 64, hi, q0, bi);
        tma_load(base + L::kDO + off, &tm_do, bar_q, c * 64, hi, q0, bi);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) {
          // both consumers are done with the tile this stage held
          mbar_wait(bar_empty + 8 * st, ((j / kStages) - 1) & 1);
        }
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          const uint32_t off = st * L::kTileBytes + c * kBK * kRowBytes;
          tma_load(base + L::kK + off, &tm_k, full, c * 64, g, j * kBK, bi);
          tma_load(base + L::kV + off, &tm_v, full, c * 64, g, j * kBK, bi);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows q0 + 64w .. q0 + 64w + 63.
  // Accumulator fragments are [64 queries x n]: d[4j + e] is row r_lo (+8
  // for e >= 2), column 8j + 2 quad + (e & 1)
  const int w = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // and r_lo + 8
  const int wg_row0 = q0 + 64 * w;
  const int row0 = wg_row0 + r_lo;
  const int row1 = row0 + 8;
  const uint32_t q_rows = base + L::kQ + 64 * w * kRowBytes;
  const uint32_t do_rows = base + L::kDO + 64 * w * kRowBytes;
  // each row's lse in log2 units and delta; rows past s read TMA's zeros
  // for Q and dO, and (+inf, 0) here, so their probabilities are 0
  const float inf = __int_as_float(0x7f800000);
  const float lse0 = row0 < s ? lse[(size_t)bh * s + row0] * kLog2e : inf;
  const float lse1 = row1 < s ? lse[(size_t)bh * s + row1] * kLog2e : inf;
  const float delta0 = row0 < s ? delta[(size_t)bh * s + row0] : 0.f;
  const float delta1 = row1 < s ? delta[(size_t)bh * s + row1] : 0.f;

  float dq[D / 2];
  float sc[kBK / 2];  // S, then P
  float dp[kBK / 2];  // dP, then dS
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kStages;
    mbar_wait(bar_full + 8 * st, (tile / kStages) & 1);
    const int k0 = tile * kBK;
    if (causal && k0 > wg_row0 + 63) {
      // every key of the tile follows every row of this warpgroup
      mbar_arrive(bar_empty + 8 * st);
      continue;
    }
    const uint32_t k_tile = base + L::kK + st * L::kTileBytes;
    const uint32_t v_tile = base + L::kV + st * L::kTileBytes;

    // S = Q.K^T and dP = dO.V^T over head_dim in steps of 16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_n64(sc,
                   desc_k_major(q_rows + (kk / 4) * kBQ * kRowBytes + col),
                   desc_k_major(k_tile + (kk / 4) * kBK * kRowBytes + col),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_n64(dp,
                   desc_k_major(do_rows + (kk / 4) * kBQ * kRowBytes + col),
                   desc_k_major(v_tile + (kk / 4) * kBK * kRowBytes + col),
                   kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp2(S scale log2e - lse log2e), dS = P (dP - delta); only the
    // causal diagonal and a ragged key tail are masked
    const bool masked =
        k0 + kBK > sk || (causal && k0 + kBK - 1 > wg_row0);
    uint32_t da[kBK / 4];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const bool hi_row = (i & 2) != 0;
      float p = ex2(fmaf(sc[i], scale_log2, -(hi_row ? lse1 : lse0)));
      if (masked) {
        const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
        if (kj >= sk || (causal && kj > (hi_row ? row1 : row0))) p = 0.f;
      }
      dp[i] = p * (dp[i] - (hi_row ? delta1 : delta0));
    }
    // dS in bf16 as the A operand: the fragment's columns 16kk..16kk+15
    // are A's layout for key step kk
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }

    // dQ += dS.K, K read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t bk = desc_mn_major(k_tile + kk * 16 * kRowBytes,
                                        kBK * kRowBytes);
      if constexpr (D == 128) {
        wgmma_rs_n128(dq, da + 4 * kk, bk);
      } else {
        wgmma_rs_n64(dq, da + 4 * kk, bk);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(dq);
    mbar_arrive(bar_empty + 8 * st);  // this thread is done with the stage
  }

  // epilogue: scale * dQ in bf16 into this warpgroup's own Q rows
  // (swizzled as TMA expects), then one TMA store per column chunk,
  // clipped at s
  uint8_t* q_out = smem + L::kQ + 64 * w * kRowBytes;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      st_swizzled(q_out + (j / 8) * kBQ * kRowBytes, r_lo + 8 * half, j % 8,
                  quad * 4, dq[i] * scale, dq[i + 1] * scale);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (tid == 0 && wg_row0 < s) {
    for (int c = 0; c < L::kChunks; ++c) {
      tma_store(&tm_dq, q_rows + c * kBQ * kRowBytes, c * 64, hi, wg_row0,
                bi);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
cudaError_t launch_d(const CUtensorMap* maps, const float* lse,
                     const float* delta, int b, int s, int sk, int h, int kvh,
                     int causal, float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  flash_bwd_dq_tc<D><<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, delta, s, sk, h, kvh,
      causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int b, int s, int sk, int h, int kvh, int d,
                   int causal, float scale, cudaStream_t stream) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  const EncodeTiledFn enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  // q, k, v, dO, dq
  CUtensorMap maps[5];
  cudaError_t err = make_map(enc, &maps[0], q, b, s, h, d, kBQ);
  if (err == cudaSuccess) err = make_map(enc, &maps[3], dout, b, s, h, d, kBQ);
  if (err == cudaSuccess) err = make_map(enc, &maps[4], dq, b, s, h, d, 64);
  if (sk > 0) {  // no key tile is read when there are no keys
    if (err == cudaSuccess) {
      err = make_map(enc, &maps[1], k, b, sk, kvh, d, kBK);
    }
    if (err == cudaSuccess) {
      err = make_map(enc, &maps[2], v, b, sk, kvh, d, kBK);
    }
  } else {
    maps[1] = maps[0];
    maps[2] = maps[0];
  }
  if (err != cudaSuccess) return err;
  return d == 64 ? launch_d<64>(maps, lse, delta, b, s, sk, h, kvh, causal,
                                scale, stream)
                 : launch_d<128>(maps, lse, delta, b, s, sk, h, kvh, causal,
                                 scale, stream);
}

}  // namespace tc

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
    err = tc::launch(q, k, v, dout, lp, dp, dq, b, s, sk, h, kvh, d, causal,
                     scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
