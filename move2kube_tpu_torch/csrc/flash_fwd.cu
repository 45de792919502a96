// Flash-attention forward (causal or full, GQA) for Hopper, sm_90a.
//
// Replaces: the TPU kernel `_flash_kernel`, launched by
// `_flash_attention_tpu` through `pl.pallas_call`
// (move2kube_tpu/ops/attention.py). Like it, the kernel optionally writes
// each row's logsumexp, which the backward kernels (flash_bwd_dq.cu,
// flash_bwd_dkv.cu) read to recompute the probabilities: fp32, laid out
// [b, h, s] (the TPU kernel broadcasts it over 128 lanes),
// lse = m + log(max(l, 1e-30)) in the units of the scaled scores.
//
// What bounds it on an H100: operations. Causal attention does about
// 2*b*h*s^2*d FLOPs against (q + k + v + o) bytes, over 100 FLOPs per byte
// at the slices' prefill and training lengths, so the tensor cores'
// 989 TFLOP/s in bf16 are the roofline.
//
// bf16 inputs take the tensor-core kernel (`tc::flash_fwd_tc`), the TPU
// kernel's own numerics on the MXU: bf16 operands, fp32 accumulation, the
// probabilities rounded to bf16 for the second product. What it does
// about the three limits of a CUDA-core design:
// - The products run on the tensor cores. S = Q.K^T is a `wgmma` with both
//   operands in shared memory, O += P.V a `wgmma` with P in registers; the
//   scale (with log2(e) folded in, for exp2) is applied to the fp32
//   scores, and Q is never pre-scaled and re-rounded.
// - No threads share a row's dot products: each consumer warpgroup owns
//   64 query rows (the M of `wgmma.m64nNk16`), and the online softmax runs
//   on the accumulator fragment, each thread holding two rows' columns;
//   row max and sum are two quad shuffles, and `l` is summed from the
//   fp32 probabilities before they are rounded.
// - Copies overlap the products: one producer thread issues TMA loads of
//   the block's Q tile once and of 128-key K/V tiles into a 2-stage ring
//   in shared memory (128-byte swizzle, the layout `wgmma` reads), each
//   stage with a full and an empty `mbarrier`; `setmaxnreg` moves
//   registers from the producer warpgroup to the two consumer warpgroups.
// One block takes (b.h, 128-row query tile), the last (longest under the
// causal mask) first. Only a tile on a warpgroup's causal diagonal, or one
// holding a ragged key tail, is masked (scores at -1e30); ragged query
// rows read zeros from TMA's out-of-bounds fill and are clipped by the
// TMA store of O, which goes through the warpgroup's own Q rows in shared
// memory. The tensor maps are encoded on the host for each call;
// `cuTensorMapEncodeTiled` comes through `cudaGetDriverEntryPoint*`, so
// the library needs no -lcuda. These Hopper pieces (barriers, TMA,
// descriptors, `wgmma`, tensor maps) are in hopper.cuh, shared with the
// backward kernels.
//
// fp32 inputs take the CUDA-core kernel (`flash_fwd_kernel`), whose fp32
// FMAs keep the JAX package's fp32 contract (no TF32): one block per
// (batch*head, 64-row query tile), 256 threads. Four threads share one
// query row, each holding a quarter of its head_dim for q and for the fp32
// output accumulator in registers; a score is their partial dots summed
// with two warp shuffles. K/V tiles (32 keys in fp32: 32 KB for both at
// d=128) are staged in shared memory with 16-byte loads and read back as
// broadcasts. The TPU kernel's fori_loop over K blocks is the loop over
// tiles here, ending at the block's causal frontier. Online softmax runs
// in chunks of 16 keys: one rescale of the accumulator per chunk instead
// of per key. Query head i reads KV head i / (h / kvh), the order
// jnp.repeat(k, rep, axis=2) gives, in both kernels. Ragged query and key
// tails are masked, so any s and sk are taken.
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16: warp-specialised tensor-core kernel (wgmma fed by TMA)
// ---------------------------------------------------------------------------

namespace tc {

using namespace m2kt::hopper;

constexpr int kBQ = 128;        // query rows per block: 64 per consumer
constexpr int kBK = 128;        // keys per K/V tile
constexpr int kStages = 2;      // K/V tiles in flight
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of one block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows). Each operand is stored as
// head_dim / 64 column chunks of [rows][128 bytes], TMA's box layout.
template <int D>
struct Smem {
  static constexpr int kChunks = D / 64;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // q, full, empty
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_o,
             float* __restrict__ lse, int s, int sk, int h, int kvh,
             int causal, float scale_log2) {
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
      mbar_init(bar_empty + 8 * st, kThreads - 128);  // every consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(base + L::kQ + c * kBQ * kRowBytes, &tm_q, bar_q, c * 64, hi,
                 q0, bi);
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

  // consumers: warpgroup w owns query rows q0 + 64w .. q0 + 64w + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // and r_lo + 8
  const int wg_row0 = q0 + 64 * w;
  const int row0 = wg_row0 + r_lo;
  const int row1 = row0 + 8;
  const uint32_t q_rows = base + L::kQ + 64 * w * kRowBytes;

  float o[D / 2];
  float sc[kBK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // row maxima, log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's part of each row sum

  mbar_wait(bar_q, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kStages;
    mbar_wait(bar_full + 8 * st, (tile / kStages) & 1);
    const uint32_t k_tile = base + L::kK + st * L::kTileBytes;
    const uint32_t v_tile = base + L::kV + st * L::kTileBytes;

    // S = Q.K^T over head_dim in steps of 16 (32 bytes of a swizzled row)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_n128(sc,
                    desc_k_major(q_rows + (kk / 4) * kBQ * kRowBytes + col),
                    desc_k_major(k_tile + (kk / 4) * kBK * kRowBytes + col),
                    kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs(sc);

    // scale to log2 units; mask only the causal diagonal and a ragged tail
    const int k0 = tile * kBK;
    const bool masked =
        k0 + kBK > sk || (causal && k0 + kBK - 1 > wg_row0);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale_log2;
    if (masked) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
        const int qi = (i & 2) ? row1 : row0;
        if (kj >= sk || (causal && kj > qi)) sc[i] = kNegInf;
      }
    }

    // online softmax on the fragment: each row's max over its quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = ex2(m0 - mx0);
    const float alpha1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - m0);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - m0);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - m1);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - m1);
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // P in bf16 as the A operand: the accumulator's columns 16kk..16kk+15
    // are exactly A's layout for key step kk
    uint32_t pa[kBK / 4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[4 * kk] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P.V over the tile's keys in steps of 16 (16 rows of V)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = desc_mn_major(v_tile + kk * 16 * kRowBytes,
                                          kBK * kRowBytes);
      if constexpr (D == 128) {
        wgmma_rs_n128(o, pa + 4 * kk, dv);
      } else {
        wgmma_rs_n64(o, pa + 4 * kk, dv);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * st);  // this thread is done with the stage
  }

  // epilogue: O / l in bf16 into this warpgroup's own Q rows (swizzled as
  // TMA expects), then one TMA store per column chunk, clipped at s
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  uint8_t* o_rows = smem + L::kQ + 64 * w * kRowBytes;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float inv = half ? inv1 : inv0;
      st_swizzled(o_rows + (j / 8) * kBQ * kRowBytes, r_lo + 8 * half, j % 8,
                  quad * 4, o[4 * j + 2 * half] * inv,
                  o[4 * j + 2 * half + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (tid == 0 && wg_row0 < s) {
    for (int c = 0; c < L::kChunks; ++c) {
      tma_store(&tm_o, q_rows + c * kBQ * kRowBytes, c * 64, hi, wg_row0, bi);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if (lse != nullptr && quad == 0) {
    if (row0 < s) {
      lse[(size_t)bh * s + row0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
    }
    if (row1 < s) {
      lse[(size_t)bh * s + row1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
    }
  }
}

template <int D>
cudaError_t launch_d(const CUtensorMap& tq, const CUtensorMap& tk,
                     const CUtensorMap& tv, const CUtensorMap& to, float* lse,
                     int b, int s, int sk, int h, int kvh, int causal,
                     float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  flash_fwd_tc<D><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, to, lse, s, sk, h, kvh, causal, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int s, int sk, int h, int kvh, int d,
                   int causal, float scale, cudaStream_t stream) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  const EncodeTiledFn enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = make_map(enc, &tq, q, b, s, h, d, kBQ);
  if (err == cudaSuccess) err = make_map(enc, &to, o, b, s, h, d, 64);
  if (sk > 0) {  // no key tile is read when there are no keys
    if (err == cudaSuccess) err = make_map(enc, &tk, k, b, sk, kvh, d, kBK);
    if (err == cudaSuccess) err = make_map(enc, &tv, v, b, sk, kvh, d, kBK);
  } else {
    tk = tq;
    tv = tq;
  }
  if (err != cudaSuccess) return err;
  return d == 64 ? launch_d<64>(tq, tk, tv, to, lse, b, s, sk, h, kvh, causal,
                                scale, stream)
                 : launch_d<128>(tq, tk, tv, to, lse, b, s, sk, h, kvh, causal,
                                 scale, stream);
}

}  // namespace tc

}  // namespace

M2KT_EXPORT_ERROR_STRING

// q [b, s, h, d], k/v [b, sk, kvh, d], o [b, s, h, d]; all contiguous, of
// one type (dtype: 0 fp32, 1 bf16), bf16 ones 16-byte aligned (TMA). lse is
// fp32 [b, h, s], or null when the caller does not want it. fp32 takes the
// CUDA-core kernel, bf16 the tensor-core one; either is one launch on
// `stream` of `device`. Returns cudaGetLastError(), or the error that kept
// the launch from being made.
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
    err = tc::launch(q, k, v, o, static_cast<float*>(lse), b, s, sk, h, kvh,
                     d, causal, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
