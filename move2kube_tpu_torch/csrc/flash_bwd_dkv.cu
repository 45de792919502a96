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
// and jnp.repeat's VJP sums dk/dv over each group. These kernels take K/V
// at kvh heads, as the forward does, and return dk/dv at kvh heads holding
// that sum: a block owns one (batch, KV head, key tile) and loops over the
// h / kvh query heads of its group.
//
// What bounds it on an H100: operations. It does four products of the
// forward's size (q.k^T, dO.v^T, p^T.dO, ds^T.q) under the mask against
// reading q, k, v, dO and writing dk, dv once, so the tensor cores' 989
// TFLOP/s bf16 are the roofline.
//
// bf16 inputs take the tensor-core kernel (`tc::flash_bwd_dkv_tc`), with
// the TPU kernel's MXU numerics: bf16 operands, fp32 sums, p and ds
// computed in fp32 and rounded to bf16 for the products that make dv and
// dk. A block owns one (batch, KV head, 128-key tile); each of its two
// warpgroups owns 64 keys (the M of `wgmma.m64nNk16`) and keeps their dK
// and dV accumulators in registers while a ring of 64-row (Q, dO) tiles
// runs over the group's query heads and, under the causal mask, from the
// key tile's diagonal to s. Per tile:
// - S^T = K.Q^T and dP^T = V.dO^T are `wgmma` products with both operands
//   in shared memory, K-major in their natural swizzled [rows, d] layout;
// - P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - delta)
//   on the accumulator fragments, lse and delta per column from shared
//   memory; only a tile on the causal diagonal is masked;
// - dV += P^T.dO and dK += dS^T.Q are `wgmma` products with the rounded
//   fragments as A in registers and dO and Q read MN-major from the same
//   tiles.
// dK is scaled once at the end; dK and dV go out through the block's own
// K and V rows in shared memory and TMA stores clipped at sk. Registers
// set the block's shape: the accumulators alone take 192 a thread at
// d=128, and ptxas holds a `wgmma` kernel of more than 256 threads to 168
// (`setmaxnreg` does not lift it: with a producer warpgroup the kernel
// spilled 336 bytes and serialised its products). So the block is the two
// warpgroups only (256 threads, up to 255 registers) and its first warp
// issues the copies: K and V once by TMA, and each ring tile two tiles
// ahead, Q and dO by TMA and lse and delta by `cp.async`, all completing
// one full `mbarrier` per stage; every thread arrives on the stage's empty
// barrier when done with it. Rows past s read zeros in Q and dO, which add
// nothing to either product; key rows past sk are not written.
//
// fp32 inputs take the CUDA-core kernel (`flash_bwd_dkv_kernel`), whose
// fp32 FMAs keep the JAX package's fp32 contract (no TF32): the forward's
// layout, transposed. 128 threads; four threads share one key row, each
// holding a quarter of its head_dim of k, v and of the two fp32
// accumulators in registers (128 floats at d=128). Query tiles of q and
// dO (32 rows: 32 KB for both at d=128) with their lse and delta are
// staged in shared memory and read back as broadcasts. One query at a
// time, the block computes the score and dO.v^T (partial dots summed with
// warp shuffles), then folds p.dO into dv and ds.q into dk, reloading the
// query's q and dO rows from shared memory (m2kt::reload_barrier) rather
// than keeping them in registers. Registers are this kernel's limit: the
// tile and chunk sizes were picked on an H100 among 4 or 8 threads a row,
// 16 to 64 rows and chunks of 1 to 8 queries; chunks of 8 spilled 2 KB a
// thread and ran 5.8x slower. Ragged key rows and query tails are masked
// here: a masked position has p = 0 and adds nothing.
//
// Both kernels schedule key tiles first to last, which under the causal
// mask is longest first, and write each dk/dv row once, from the threads
// that own it: no atomics, and the same result every run.
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma fed by TMA and cp.async)
// ---------------------------------------------------------------------------

namespace tc {

using namespace m2kt::hopper;

constexpr int kBK = 128;   // key rows per block: 64 per warpgroup
constexpr int kBQ = 64;    // query rows per ring tile
constexpr int kStages = 4; // (Q, dO) tiles in the ring
constexpr int kAhead = 2;  // tiles loaded ahead of the one in use
constexpr int kThreads = 256;  // two warpgroups, no producer warp

// Shared memory of one block, in bytes from a 1024-byte aligned base: the
// block's K and V rows, then a ring of Q and dO tiles with each tile's lse
// and delta, then the barriers (kv, full, empty).
template <int D>
struct Smem {
  static constexpr int kChunks = D / 64;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kTileBytes = kBQ * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kLse = kDO + kStages * kTileBytes;
  static constexpr int kDelta = kLse + kStages * kBQ * 4;
  static constexpr int kBars = kDelta + kStages * kBQ * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// 4 bytes from global to shared memory, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Load ring tile j (query head g * rep + j / n_q_tiles, rows q0 .. q0 + 63)
// into stage j % kStages, completing its full barrier: Q and dO by TMA
// (lane 0), lse and delta by cp.async (every lane of the warp). Rows past
// s read zeros, in Q and dO too, so they add nothing to dV = P^T.dO or to
// dK = dS^T.Q.
template <int D>
__device__ __forceinline__ void load_tile(
    int j, uint32_t base, const CUtensorMap* tm_q, const CUtensorMap* tm_do,
    const float* lse, const float* delta, int bi, int g, int rep, int h,
    int s, int q_begin, int n_q_tiles, int lane, uint32_t bar_full) {
  using L = Smem<D>;
  const int hi = g * rep + j / n_q_tiles;
  const int q0 = q_begin + (j % n_q_tiles) * kBQ;
  const int st = j % kStages;
  const uint32_t full = bar_full + 8 * st;
  const size_t row = ((size_t)bi * h + hi) * s;
  for (int i = lane; i < kBQ; i += 32) {
    const int qi = min(q0 + i, s - 1);
    const bool valid = q0 + i < s;
    cp_async_4(base + L::kLse + (st * kBQ + i) * 4, lse + row + qi, valid);
    cp_async_4(base + L::kDelta + (st * kBQ + i) * 4, delta + row + qi,
               valid);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   full)
               : "memory");
  if (lane == 0) {
    mbar_expect_tx(full, 2 * L::kTileBytes);
    for (int c = 0; c < L::kChunks; ++c) {
      const uint32_t off = st * L::kTileBytes + c * kBQ * kRowBytes;
      tma_load(base + L::kQ + off, tm_q, full, c * 64, hi, q0, bi);
      tma_load(base + L::kDO + off, tm_do, full, c * 64, hi, q0, bi);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_dk,
                 const __grid_constant__ CUtensorMap tm_dv,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int s, int sk, int h,
                 int kvh, int causal, float scale, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
  const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta);
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_full = bar_kv + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int bi = blockIdx.x / kvh;
  const int g = blockIdx.x % kvh;
  const int rep = h / kvh;
  const int k0 = blockIdx.y * kBK;
  // query rows before k0 see none of the block's keys
  const int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  const int n_q_tiles = q_begin < s ? (s - q_begin + kBQ - 1) / kBQ : 0;
  const int n = rep * n_q_tiles;  // ring tiles: query tiles of each head

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 33);  // TMA's arrival + 32 lanes' cp.async
      mbar_init(bar_empty + 8 * st, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup w owns key rows kw .. kw + 63. Accumulator fragments are
  // [64 keys x n]: d[4j + e] is key row r_lo (+8 for e >= 2), column
  // 8j + 2 quad + (e & 1)
  const int w = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // and r_lo + 8
  const int kw = k0 + 64 * w;
  const bool loader = threadIdx.x < 32;  // the first warp issues the copies
  const uint32_t k_rows = base + L::kK + 64 * w * kRowBytes;
  const uint32_t v_rows = base + L::kV + 64 * w * kRowBytes;

  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kKVBytes);
      for (int c = 0; c < L::kChunks; ++c) {
        const uint32_t off = c * kBK * kRowBytes;
        tma_load(base + L::kK + off, &tm_k, bar_kv, c * 64, g, k0, bi);
        tma_load(base + L::kV + off, &tm_v, bar_kv, c * 64, g, k0, bi);
      }
    }
    for (int j = 0; j < min(kAhead, n); ++j) {
      load_tile<D>(j, base, &tm_q, &tm_do, lse, delta, bi, g, rep, h, s,
                   q_begin, n_q_tiles, lane, bar_full);
    }
  }

  float dk[D / 2];
  float dv[D / 2];
  float sT[kBQ / 2];  // S^T, then P^T
  float dp[kBQ / 2];  // dP^T, then dS^T
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBQ / 2; ++i) sT[i] = dp[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n; ++j) {
    const int jn = j + kAhead;
    if (loader && jn < n) {
      if (jn >= kStages) {
        // both warpgroups are done with the tile this stage held
        mbar_wait(bar_empty + 8 * (jn % kStages), ((jn / kStages) - 1) & 1);
      }
      load_tile<D>(jn, base, &tm_q, &tm_do, lse, delta, bi, g, rep, h, s,
                   q_begin, n_q_tiles, lane, bar_full);
    }
    const int q0 = q_begin + (j % n_q_tiles) * kBQ;
    const int st = j % kStages;
    mbar_wait(bar_full + 8 * st, (j / kStages) & 1);
    if (causal && q0 + kBQ - 1 < kw) {
      // every query of the tile precedes every key of this warpgroup
      mbar_arrive(bar_empty + 8 * st);
      continue;
    }
    const uint32_t q_tile = base + L::kQ + st * L::kTileBytes;
    const uint32_t do_tile = base + L::kDO + st * L::kTileBytes;

    // S^T = K.Q^T and dP^T = V.dO^T over head_dim in steps of 16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_n64(sT,
                   desc_k_major(k_rows + (kk / 4) * kBK * kRowBytes + col),
                   desc_k_major(q_tile + (kk / 4) * kBQ * kRowBytes + col),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_n64(dp,
                   desc_k_major(v_rows + (kk / 4) * kBK * kRowBytes + col),
                   desc_k_major(do_tile + (kk / 4) * kBQ * kRowBytes + col),
                   kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs(sT);
    fence_regs(dp);

    // P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - delta),
    // with lse and delta per column (query); only a tile on the causal
    // diagonal is masked
    const bool masked = causal && q0 < kw + 63;
    const float* lse_t = lse_s + st * kBQ;
    const float* delta_t = delta_s + st * kBQ;
#pragma unroll
    for (int jj = 0; jj < kBQ / 8; ++jj) {
      const int c = 8 * jj + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const float l = ((e & 1) ? l2.y : l2.x) * kLog2e;
        float p = ex2(fmaf(sT[i], scale_log2, -l));
        if (masked && kw + r_lo + 8 * (e >> 1) > q0 + c + (e & 1)) p = 0.f;
        sT[i] = p;
        dp[i] = p * (dp[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
    // P^T and dS^T in bf16 as A operands: the fragment's columns
    // 16kk..16kk+15 are A's layout for query step kk
    uint32_t pa[kBQ / 4];
    uint32_t da[kBQ / 4];
#pragma unroll
    for (int i = 0; i < kBQ / 4; ++i) {
      pa[i] = pack_bf16(sT[2 * i], sT[2 * i + 1]);
      da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }

    // dV += P^T.dO and dK += dS^T.Q, dO and Q read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint64_t bdo = desc_mn_major(do_tile + kk * 16 * kRowBytes,
                                         kBQ * kRowBytes);
      const uint64_t bq = desc_mn_major(q_tile + kk * 16 * kRowBytes,
                                        kBQ * kRowBytes);
      if constexpr (D == 128) {
        wgmma_rs_n128(dv, pa + 4 * kk, bdo);
        wgmma_rs_n128(dk, da + 4 * kk, bq);
      } else {
        wgmma_rs_n64(dv, pa + 4 * kk, bdo);
        wgmma_rs_n64(dk, da + 4 * kk, bq);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(bar_empty + 8 * st);  // this thread is done with the stage
  }

  // epilogue: scale * dK and dV in bf16 into this warpgroup's own K and V
  // rows (swizzled as TMA expects), then TMA stores clipped at sk
  uint8_t* k_out = smem + L::kK + 64 * w * kRowBytes;
  uint8_t* v_out = smem + L::kV + 64 * w * kRowBytes;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      const int i = 4 * j + 2 * half;
      st_swizzled(k_out + (j / 8) * kBK * kRowBytes, r, j % 8, quad * 4,
                  dk[i] * scale, dk[i + 1] * scale);
      st_swizzled(v_out + (j / 8) * kBK * kRowBytes, r, j % 8, quad * 4,
                  dv[i], dv[i + 1]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (tid == 0 && kw < sk) {
    for (int c = 0; c < L::kChunks; ++c) {
      const uint32_t off = c * kBK * kRowBytes;
      tma_store(&tm_dk, k_rows + off, c * 64, g, kw, bi);
      tma_store(&tm_dv, v_rows + off, c * 64, g, kw, bi);
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
      flash_bwd_dkv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * kvh, (sk + kBK - 1) / kBK);
  flash_bwd_dkv_tc<D><<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], lse, delta, s,
      sk, h, kvh, causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int b, int s, int sk, int h, int kvh,
                   int d, int causal, float scale, cudaStream_t stream) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  const EncodeTiledFn enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  // q, k, v, dO, dk, dv
  CUtensorMap maps[6];
  cudaError_t err = make_map(enc, &maps[0], q, b, s, h, d, kBQ);
  if (err == cudaSuccess) err = make_map(enc, &maps[1], k, b, sk, kvh, d, kBK);
  if (err == cudaSuccess) err = make_map(enc, &maps[2], v, b, sk, kvh, d, kBK);
  if (err == cudaSuccess) err = make_map(enc, &maps[3], dout, b, s, h, d, kBQ);
  if (err == cudaSuccess) err = make_map(enc, &maps[4], dk, b, sk, kvh, d, 64);
  if (err == cudaSuccess) err = make_map(enc, &maps[5], dv, b, sk, kvh, d, 64);
  if (err != cudaSuccess) return err;
  return d == 64 ? launch_d<64>(maps, lse, delta, b, s, sk, h, kvh, causal,
                                scale, stream)
                 : launch_d<128>(maps, lse, delta, b, s, sk, h, kvh, causal,
                                 scale, stream);
}

}  // namespace tc

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
    err = tc::launch(q, k, v, dout, lp, dp, dk, dv, b, s, sk, h, kvh, d,
                     causal, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
