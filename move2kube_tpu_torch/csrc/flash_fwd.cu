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
// the library needs no -lcuda.
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
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked

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

// ---------------------------------------------------------------------------
// bf16: warp-specialised tensor-core kernel (wgmma fed by TMA)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;        // query rows per block: 64 per consumer
constexpr int kBK = 128;        // keys per K/V tile
constexpr int kStages = 2;      // K/V tiles in flight
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kRowBytes = 128;  // a swizzled row: 64 bf16 of head_dim
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait of about
// ten seconds means a copy or an arrival was lost: trap, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// One box of a [b, rows, heads, d] tensor, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor for a 128-byte swizzled operand:
// start address, leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Q and K: rows along M/N, head_dim contiguous (K-major); 8-row groups are
// 1024 bytes apart, the leading offset is unused under the swizzle.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// V as B of P.V: keys along K, head_dim contiguous (MN-major); 8-key groups
// are 1024 bytes apart, and the next 64 columns of head_dim one chunk of
// the tile (kBK rows of 128 bytes) further.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return desc_sw128(addr, kBK * kRowBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory,
// both K-major. Accumulator layout (per thread of the warpgroup, warp w,
// lane l): d[4j + e] is row 16w + l/4 (+8 for e >= 2), column
// 8j + 2(l%4) + (e & 1).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] . B[16 x N], A in registers (four bf16x2 a
// thread: rows 16w + l/4 and +8, columns 2(l%4) and +8, the accumulator's
// layout), B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
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
      const uint64_t dv = desc_mn_major(v_tile + kk * 16 * kRowBytes);
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
      const int r = r_lo + 8 * half;
      const float inv = half ? inv1 : inv0;
      const int off = (j / 8) * kBQ * kRowBytes + r * kRowBytes +
                      (((j % 8) ^ (r % 8)) * 16) + quad * 4;
      *reinterpret_cast<uint32_t*>(o_rows + off) = pack_bf16(
          o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A bf16 [b, rows, heads, d] tensor as boxes of (64 columns, 1 head,
// box_rows rows, 1 batch) in 128-byte swizzled rows; rows past `rows` read
// as zeros and are not written.
cudaError_t make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                     int b, int rows, int heads, int d, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)rows * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
