// Split-and-merge paged decode for Hopper sm_90a: the design that
// csrc/paged_decode.cu (fp32/bf16 pools) and csrc/paged_decode_int8.cu
// (int8 pools with fp32 row scales) instantiate. Each of those files says
// which TPU kernel it replaces; this header says how the work is cut.
//
// One query token per sequence attends over that sequence's paged
// context. Each KV head serves rep = h / kvh query heads, which share its
// K and V rows, so the work is a few FLOPs per byte and the bytes bound it.
// One block per (sequence, KV head) left most SMs idle at batch 8 and made
// the longest sequence one block's serial chain; here the context is cut
// into splits of whole pages over the grid (split, KV head, sequence):
//
// 1. Split pass (`paged_decode_split`). A block of kWarps warps takes one
//    split of pages_per_split pages (a multiple of 8 tokens) of one
//    (sequence, KV head). The grid is sized from max_blocks, so the host
//    reads no seq_lens; a block whose split starts at or past its
//    sequence's length returns at once. The sequence's length, the block
//    table entries of the split and the query rows are read in one round
//    trip; each 8-token group's pool row then goes to shared memory, so a
//    copy's address needs no division. All of the split's stages of
//    kStageTokens tokens (up to Stage::kRing, a ring beyond that) are then
//    in flight at once: K and V rows by cp.async, 16 bytes a lane
//    (consecutive lanes on consecutive bytes of a row), int8 scales (strided
//    by kvh * 4 bytes) by 4-byte cp.async, each stage completing an
//    mbarrier. Only rows of 8-token groups that start below the length are
//    copied, so only pages below ceil(seq_len / block_size) are touched and
//    the null page behind unused table entries is never read; rows past
//    the length in such a group are zero-filled, not read. Warp w takes
//    group w of each stage, a lane holding d / 32 consecutive elements of
//    each row (from shared memory, where the copy's layout no longer
//    matters). The group's rep * 8 partial dots are summed over the warp by
//    a transpose-reduce (rep * 8 - 1 shuffles, not 5 a score); rows past
//    the length score kNegInf; the probabilities go through shared memory
//    to every lane for acc += p v. The warps' states are merged in warp
//    order into the split's (m, l, acc[rep][d]), in fp32. A sequence that
//    fits in one split writes its output here and uses no workspace; the
//    others write the partial to the workspace.
// 2. Merge pass (`paged_decode_merge`), launched by the same C entry point
//    on the same stream as a programmatic dependent launch (its blocks may
//    be scheduled while the split pass drains, and wait in
//    griddepcontrol.wait): one block per (query head, sequence) reads
//    seq_lens to know how many splits are live and merges their partials
//    in split order,
//      M = max_i m_i,  out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30).
//    A fixed order and no atomics: the result is the same bits on every run.
//    A split wholly past the end wrote nothing and is not read. A second
//    kernel rather than the last-arriving split block behind a counter:
//    the workspace is a fresh torch.empty each call, and a self-resetting
//    counter would need zeroed memory that outlives the call, per stream.
//
// Workspace: [b, kvh, n_split, rep * (d + 2)] fp32, per split acc[rep][d]
// then m[rep] then l[rep]; the wrapper allocates it, the kernels allocate
// nothing.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace m2kt {

// N (2 or 4) consecutive int8 values as fp32, in one 16- or 32-bit load.
template <int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  if constexpr (N == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
    static_assert(N == 2, "load_vec<int8>: N must be 2 or 4");
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x; out[1] = c.y;
  }
}

// Internal linkage: each kernel library holds its own copy (with its own
// once-per-device flags), whatever else the process has loaded.
namespace paged {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;  // consecutive tokens a warp takes at a time
constexpr int kStageTokens = kWarps * kGroup;
constexpr int kMaxRing = 8;

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;  // int8 pools only
  const float* v_scale;
  const int* block_tables;
  const int* seq_lens;
  void* o;
  float* ws;  // null when n_split == 1
  int b, h, kvh, block_size, max_blocks, pages_per_split, n_split;
  int ring;  // stages in the ring: all of a split's, up to Stage::kRing
  float scale;
};

template <typename P, int D>
struct Stage {
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(P));
  static constexpr int kPieces = kRowBytes / 16;  // 16-byte copies a row
  static constexpr int kRows = kStageTokens * kRowBytes;  // K (or V) rows
  static constexpr int kBytes = 2 * kRows + (kQuant ? 2 * kStageTokens * 4 : 0);
  // at most 96 KB of stages, so that two long splits fit an SM
  static constexpr int kRing = 96 * 1024 / kBytes < 1 ? 1
                               : 96 * 1024 / kBytes > kMaxRing ? kMaxRing
                               : 96 * 1024 / kBytes;
  // the ring, or the warps' states for their merge where that is larger;
  // the split's row offsets (one int64 an 8-token group) follow it
  template <int REP>
  __host__ __device__ static constexpr int ring_bytes(int ring) {
    return ring * kBytes > kWarps * REP * (D + 2) * 4
               ? ring * kBytes : kWarps * REP * (D + 2) * 4;
  }
  template <int REP>
  static constexpr int smem(int ring, int split_tok) {
    return ring_bytes<REP>(ring) + split_tok / kGroup * 8;
  }
};

__device__ __forceinline__ int live_tokens(const Args& a, int bi) {
  return min(max(a.seq_lens[bi], 0), a.max_blocks * a.block_size);
}

// 16 (or 4) bytes from global to shared memory, or as many zero bytes
// without reading global memory when !valid.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0));
}

// The stage's full barrier counts one arrival of each thread, made when
// that thread's copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Copy the stage of the split starting at token s0 into its ring slot:
// every row of an 8-token group that starts below t1, and for int8 pools
// the rows' scales; rows (and scales) at or past t1 in such a group are
// zero-filled, not read, so a stale or NaN row past seq_len never reaches
// shared memory. `grp` holds the pool row of the first token of each of
// the split's 8-token groups (its page's, its KV head's), t0 the split's
// first token: a row's address is grp[u / 8] + (u % 8) * kvh, no division.
template <typename P, int D>
__device__ __forceinline__ void issue_stage(const Args& a, uint8_t* slot,
                                            const int64_t* grp, int t0,
                                            int s0, int t1) {
  using S = Stage<P, D>;
#pragma unroll
  for (int i = 0; i < 2 * kStageTokens * S::kPieces / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int piece = idx % S::kPieces;
    const int row = (idx / S::kPieces) % kStageTokens;
    const int kv = idx / (S::kPieces * kStageTokens);
    const int u = s0 + row - t0;  // token of the split
    if (((s0 + row) & ~(kGroup - 1)) < t1) {
      const int64_t r = grp[u / kGroup] + (u % kGroup) * a.kvh;
      const void* pool = kv ? a.v_pages : a.k_pages;
      cp_async_16(slot + kv * S::kRows + row * S::kRowBytes + piece * 16,
                  static_cast<const uint8_t*>(pool) +
                      (r * S::kRowBytes + piece * 16),
                  s0 + row < t1);
    }
  }
  if constexpr (S::kQuant) {
    if (threadIdx.x < 2 * kStageTokens) {
      const int row = threadIdx.x % kStageTokens;
      const int kv = threadIdx.x / kStageTokens;
      const int u = s0 + row - t0;
      if (((s0 + row) & ~(kGroup - 1)) < t1) {
        const int64_t r = grp[u / kGroup] + (u % kGroup) * a.kvh;
        float* scales = reinterpret_cast<float*>(slot + 2 * S::kRows);
        cp_async_4(scales + kv * kStageTokens + row,
                   (kv ? a.v_scale : a.k_scale) + r, s0 + row < t1);
      }
    }
  }
}

// A group's scores, reduced over the warp by halving exchanges (a
// transpose-reduce): each lane holds partial dots v[i], i = r * kGroup + t,
// over its d / 32 columns; at each step (lane masks 16, 8, ...) a lane
// keeps the upper or the lower half of its values, by its bit of the
// mask, and adds its partner's copy of that half. N = rep * 8 values take
// N - 1 shuffles (at most 5 steps, then full sums while N < 32) instead
// of 5 N, and leave each lane N / 32 (or one) of them, whole.
template <int N, int MASK = 16>
__device__ __forceinline__ void transpose_reduce(float* v, int lane) {
  if constexpr (MASK > 0) {
    if constexpr (N > 1) {
      const bool upper = lane & MASK;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
      }
      transpose_reduce<N / 2, MASK / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], MASK);
      transpose_reduce<1, MASK / 2>(v, lane);
    }
  }
}

// Which of the N values transpose_reduce left in the lane's slot j.
template <int N>
__device__ __forceinline__ int reduced_index(int lane, int j) {
  int idx = j;
  int half = N;
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1) {
    if (half > 1) {
      half >>= 1;
      if (lane & mask) idx += half;
    }
  }
  return idx;
}

// Max (or sum) over the 8 tokens of a query head: over the lanes whose
// reduced values differ only in t (the low 3 bits of the index).
template <int N, bool kMax>
__device__ __forceinline__ float over_tokens(float x) {
  int half = N;
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1) {
    if (half > 1) {
      half >>= 1;
      if (half <= kGroup / 2) {
        const float y = __shfl_xor_sync(0xffffffffu, x, mask);
        x = kMax ? fmaxf(x, y) : x + y;
      }
    }
  }
  return x;
}

template <typename T, typename P, int D, int REP>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const Args a) {
  using S = Stage<P, D>;
  constexpr int E = D / 32;  // elements of a row per lane
  static_assert(E == 2 || E == 4, "unsupported D");
  extern __shared__ __align__(16) uint8_t smem[];
  // the merge pass may start launching now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __shared__ __align__(8) uint64_t full[kMaxRing];
  // the sequence's length, the block-table entry of this thread's 8-token
  // group of the split and the query rows, all in flight together: one
  // round trip before the copies
  const int split_tok = a.pages_per_split * a.block_size;
  const int t0 = split * split_tok;
  const int n_grp = split_tok / kGroup;
  const int n_tok = live_tokens(a, bi);
  const int* bt = a.block_tables + static_cast<size_t>(bi) * a.max_blocks;
  const int u0 = t0 + threadIdx.x * kGroup;
  const bool has_grp = threadIdx.x < n_grp && u0 / a.block_size < a.max_blocks;
  const int entry = has_grp ? bt[u0 / a.block_size] : 0;
  float qr[REP][E];
  float acc[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const T* q_row = static_cast<const T*>(a.q) +
                     (static_cast<size_t>(bi) * a.h + g * REP + r) * D +
                     lane * E;
    load_vec<E>(q_row, qr[r]);
  }
  if (split > 0 && t0 >= n_tok) return;  // wholly past the end
  const int t1 = min(t0 + split_tok, n_tok);
  const int n_stages = (t1 - t0 + kStageTokens - 1) / kStageTokens;
  // the pool row of each 8-token group's first token (its page's, its KV
  // head's): the copies' addresses need no division
  int64_t* grp =
      reinterpret_cast<int64_t*>(smem + S::template ring_bytes<REP>(a.ring));
  if (has_grp) {
    grp[threadIdx.x] =
        (static_cast<int64_t>(entry) * a.block_size + u0 % a.block_size) *
            a.kvh + g;
  }
  for (int k = threadIdx.x + kThreads; k < n_grp; k += kThreads) {
    const int u = t0 + k * kGroup;
    if (u / a.block_size < a.max_blocks) {
      grp[k] = (static_cast<int64_t>(bt[u / a.block_size]) * a.block_size +
                u % a.block_size) * a.kvh + g;
    }
  }
  if (threadIdx.x < a.ring) {
    hopper::mbar_init(hopper::smem_u32(&full[threadIdx.x]), kThreads);
  }
  __syncthreads();
  // every stage of the split in flight at once, as far as the ring holds
  for (int j = 0; j < min(a.ring, n_stages); ++j) {
    issue_stage<P, D>(a, smem + j * S::kBytes, grp, t0,
                      t0 + j * kStageTokens, t1);
    cp_async_arrive(hopper::smem_u32(&full[j]));
  }

  // kN scores a group; the lane's kLeft of them are (r, t) = idx / 8, idx % 8
  // for idx = reduced_index(lane, k); its online-softmax state is that of
  // its query head r (the same m in every lane of the head), l summed over
  // its own tokens, acc[rep][d / 32] for every head
  constexpr int kN = REP * kGroup;
  constexpr int kLeft = kN > 32 ? kN / 32 : 1;
  const int own_r = reduced_index<kN>(lane, 0) / kGroup;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[r][e] *= a.scale;
      acc[r][e] = 0.f;
    }
  }
  float m_own = kNegInf;
  float l_own = 0.f;
  // a warp's probabilities (times v_scale for int8) and rescales, shared
  // with its lanes through shared memory
  __shared__ __align__(16) float probs[kWarps][kN + 8];
  float* w_p = probs[warp];
  float* w_alpha = w_p + kN;

  for (int j = 0; j < n_stages; ++j) {
    const int st = j % a.ring;
    hopper::mbar_wait(hopper::smem_u32(&full[st]), (j / a.ring) & 1);
    const uint8_t* slot = smem + st * S::kBytes;
    const int base = t0 + j * kStageTokens + warp * kGroup;
    if (base < t1) {
      const P* k_rows = reinterpret_cast<const P*>(slot) +
                        warp * kGroup * D + lane * E;
      const P* v_rows = reinterpret_cast<const P*>(slot + S::kRows) +
                        warp * kGroup * D + lane * E;
      const float* scales =
          reinterpret_cast<const float*>(slot + 2 * S::kRows) +
          warp * kGroup;
      float v[kN];
      {
        float kf[kGroup][E];
#pragma unroll
        for (int t = 0; t < kGroup; ++t) load_vec<E>(k_rows + t * D, kf[t]);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
#pragma unroll
          for (int t = 0; t < kGroup; ++t) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) part = fmaf(qr[r][e], kf[t][e], part);
            v[r * kGroup + t] = part;
          }
        }
      }
      transpose_reduce<kN>(v, lane);
      float gmax = kNegInf;
#pragma unroll
      for (int k = 0; k < kLeft; ++k) {
        const int t = reduced_index<kN>(lane, k) % kGroup;
        if constexpr (S::kQuant) v[k] *= scales[t];
        v[k] = base + t < t1 ? v[k] : kNegInf;
        gmax = fmaxf(gmax, v[k]);
      }
      const float m_new = fmaxf(m_own, over_tokens<kN, true>(gmax));
      const float alpha = expf(m_own - m_new);
      m_own = m_new;
      l_own *= alpha;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kLeft; ++k) {
        const int idx = reduced_index<kN>(lane, k);
        const float p = expf(v[k] - m_new);
        l_own += p;
        w_p[idx] = S::kQuant ? p * scales[kStageTokens + idx % kGroup] : p;
        if (idx % kGroup == 0) w_alpha[idx / kGroup] = alpha;
      }
      __syncwarp();
      float vf[kGroup][E];
#pragma unroll
      for (int t = 0; t < kGroup; ++t) load_vec<E>(v_rows + t * D, vf[t]);
      // rows past seq_len are zeros here and their p is 0
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float ar = w_alpha[r];
        const float4 p0 = reinterpret_cast<const float4*>(w_p + r * kGroup)[0];
        const float4 p1 = reinterpret_cast<const float4*>(w_p + r * kGroup)[1];
        const float pr[kGroup] = {p0.x, p0.y, p0.z, p0.w,
                                  p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= ar;
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[r][e] = fmaf(pr[t], vf[t][e], acc[r][e]);
          }
        }
      }
    }
    if (j + a.ring < n_stages) {  // the slot again, once every warp is done
      __syncthreads();
      issue_stage<P, D>(a, smem + st * S::kBytes, grp, t0,
                        t0 + (j + a.ring) * kStageTokens, t1);
      cp_async_arrive(hopper::smem_u32(&full[st]));
    }
  }

  // the warps' states, merged in warp order through the (now idle) ring
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(smem);
  float* sm_l = sm_m + kWarps * REP;
  float* sm_acc = sm_l + kWarps * REP;
  l_own = over_tokens<kN, false>(l_own);
  if (reduced_index<kN>(lane, 0) % kGroup == 0) {
    sm_m[warp * REP + own_r] = m_own;
    sm_l[warp * REP + own_r] = l_own;
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sm_acc[(warp * REP + r) * D + lane * E + e] = acc[r][e];
    }
  }
  __syncthreads();
  const bool whole = n_tok <= split_tok;  // one split: no merge pass
  float* part = whole ? nullptr
                      : a.ws + ((static_cast<size_t>(bi) * a.kvh + g) *
                                    a.n_split + split) * (REP * (D + 2));
  for (int idx = threadIdx.x; idx < REP * D; idx += kThreads) {
    const int r = idx / D;
    const int di = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * REP + r]);
    float lsum = 0.f;
    float out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * REP + r] - mx);
      lsum += sm_l[w * REP + r] * c;
      out += sm_acc[(w * REP + r) * D + di] * c;
    }
    if (whole) {
      store_one(static_cast<T*>(a.o) +
                    (static_cast<size_t>(bi) * a.h + g * REP + r) * D + di,
                out / fmaxf(lsum, 1e-30f));
    } else {
      part[r * D + di] = out;
      if (di == 0) {
        part[REP * D + r] = mx;
        part[REP * D + REP + r] = lsum;
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D) paged_decode_merge(const Args a) {
  // splits whose loads are issued together, before any is used: indices
  // past the last live split read that split again and are not summed
  constexpr int kChunk = 16;
  const int head = blockIdx.x;
  const int bi = blockIdx.y;
  const int di = threadIdx.x;
  const int rep = a.h / a.kvh;
  const int g = head / rep;
  const int r = head % rep;
  const int split_tok = a.pages_per_split * a.block_size;
  const int n_live = (live_tokens(a, bi) + split_tok - 1) / split_tok;
  if (n_live <= 1) return;  // the split pass wrote the output
  // the split pass's partials are visible once its grid has ended
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int stride = rep * (D + 2);
  const float* part =
      a.ws + (static_cast<size_t>(bi) * a.kvh + g) * a.n_split * stride;
  const float* part_acc = part + r * D + di;
  const float* part_m = part + rep * D + r;
  const float* part_l = part_m + rep;
  // the first chunk whole, then only the m of the others: M over all
  float mv[kChunk];
  float lv[kChunk];
  float av[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int i = min(k, n_live - 1) * stride;
    mv[k] = part_m[i];
    lv[k] = part_l[i];
    av[k] = part_acc[i];
  }
  float mx = kNegInf;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) mx = fmaxf(mx, mv[k]);
  for (int c0 = kChunk; c0 < n_live; c0 += kChunk) {
    float mc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      mc[k] = part_m[min(c0 + k, n_live - 1) * stride];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) mx = fmaxf(mx, mc[k]);
  }
  // the sums in split order
  float num = 0.f;
  float den = 0.f;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (k < n_live) {
      const float c = expf(mv[k] - mx);
      den += lv[k] * c;
      num += av[k] * c;
    }
  }
  for (int c0 = kChunk; c0 < n_live; c0 += kChunk) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = min(c0 + k, n_live - 1) * stride;
      mv[k] = part_m[i];
      lv[k] = part_l[i];
      av[k] = part_acc[i];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (c0 + k < n_live) {
        const float c = expf(mv[k] - mx);
        den += lv[k] * c;
        num += av[k] * c;
      }
    }
  }
  store_one(static_cast<T*>(a.o) + (static_cast<size_t>(bi) * a.h + head) * D +
                di,
            num / fmaxf(den, 1e-30f));
}

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a kernel must opt in, per device,
// up to the size launched (`set` is the calling instantiation's own
// record of it): raised here when a launch needs more, not at every
// launch, so a launch captured in a CUDA graph makes no such call and a
// decode step pays for none.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int device, int* set) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && set[device] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) set[device] = bytes;
  return err;
}

template <typename T, typename P, int D>
cudaError_t launch_d(Args a, int device, cudaStream_t stream) {
  using S = Stage<P, D>;
  const int split_tok = a.pages_per_split * a.block_size;
  const int split_stages = (split_tok + kStageTokens - 1) / kStageTokens;
  a.ring = split_stages < S::kRing ? split_stages : S::kRing;
  const dim3 grid(a.n_split, a.kvh, a.b);
#define M2KT_PAGED_CASE(R)                                                   \
  case R: {                                                                  \
    static int set[kMaxDevices] = {};                                        \
    const int smem = S::template smem<R>(a.ring, split_tok);                 \
    const cudaError_t err =                                                  \
        allow_smem(paged_decode_split<T, P, D, R>, smem, device, set);       \
    if (err != cudaSuccess) return err;                                      \
    paged_decode_split<T, P, D, R><<<grid, kThreads, smem, stream>>>(a);     \
    break;                                                                   \
  }
  switch (a.h / a.kvh) {
    M2KT_PAGED_CASE(1)
    M2KT_PAGED_CASE(2)
    M2KT_PAGED_CASE(4)
    M2KT_PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef M2KT_PAGED_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  // programmatic dependent launch: the merge's blocks may be scheduled
  // while the split pass ends, and wait in griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.h, a.b);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_merge<T, D>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Check the geometry and launch both passes on `stream` of `device` for
// page type P (T itself, or int8_t) and q/o type T (dtype: 0 fp32, 1 bf16).
template <typename P>
int launch(const Args& a, int d, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.block_size % kGroup != 0 || a.kvh <= 0 || a.h % a.kvh != 0 ||
      a.pages_per_split <= 0 || a.n_split <= 0 ||
      static_cast<long long>(a.n_split) * a.pages_per_split < a.max_blocks ||
      (a.n_split > 1 && a.ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fp32 = dtype == kFloat32;
  if (!fp32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same<P, int8_t>::value) {
    if (d == 64) {
      err = fp32 ? launch_d<float, P, 64>(a, device, st)
                 : launch_d<__nv_bfloat16, P, 64>(a, device, st);
    } else if (d == 128) {
      err = fp32 ? launch_d<float, P, 128>(a, device, st)
                 : launch_d<__nv_bfloat16, P, 128>(a, device, st);
    } else {
      err = cudaErrorInvalidValue;
    }
  } else {
    if (d == 64) {
      err = launch_d<P, P, 64>(a, device, st);
    } else if (d == 128) {
      err = launch_d<P, P, 128>(a, device, st);
    } else {
      err = cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace paged
}  // namespace m2kt
