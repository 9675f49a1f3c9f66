// Bit-sliced life-like multi-step kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel make_pallas_packed_multi_step with its body
// _packed_tile_advance (tpu_life/backends/pallas_backend.py), Moore mode.
// It computes `k` masked life-like steps of a packed bitboard, each equal to
// bitlife.make_masked_packed_step on the whole board: 32 cells per 32-bit
// word, bit b of word j is column 32*j + b, int32[H, ceil(W/32)] with no
// frame.  Cells outside rows [0, H) or past column W are dead.
//
// Layout of one block: an output tile of tile_rows rows x kInterior words,
// loaded with a halo of k rows above and below and one word left and right
// into shared memory.  The block then runs k substeps in shared memory,
// ping-ponging two buffers.  Substep s recomputes only rows [s, ext - s),
// the rows whose inputs are still exact, so after k substeps the interior
// rows are exact.  Sideways, each substep reaches one cell further, so the
// one-word halo keeps the interior exact while k <= 32.  Reads outside the
// board load zero, which stands in for the TPU kernel's zero frame.
//
// Each thread owns one word column of the tile (lane = column) and walks
// down a run of rows, keeping the rows above and below in registers.  It
// forms the vertical carry-save sums (ones, twos) of its own column, takes
// the neighbour columns' sums from the adjacent lanes by warp shuffle, and
// builds the left/right neighbour planes with funnel shifts that carry the
// bit from the adjacent word.  The rule arrives as data: the minimized sum
// of products from boolmin.rule_sop, so one build serves every life-like
// rule.
//
// What bounds it on an H100: per step a word needs about 15 32-bit logic
// instructions for Conway, counting one LOP3 for any three-input function
// (carry-save adds 6, funnel shifts 4, total planes 2, rule 3; see
// logic_ops_per_word_step in kernels/packed_stripe.py), against 8 bytes of
// device-memory traffic per k steps.  Running k steps per pass cuts the
// device-memory traffic k-fold (at k = 8, 16384^2 moves 64 MiB per 8 steps,
// about 20 us at 3.35 TB/s, against about 60 us of integer issue), so
// integer-op issue is the limit.  Beyond that count the kernel spends the
// halo recompute (k rows and one word per tile), warp shuffles, shared
// memory traffic and the data-driven rule.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;               // shared-memory words per tile row
constexpr int kInterior = kLanes - 2;    // output words per tile row
constexpr int kWarps = 8;                // warps per block, each a run of rows
constexpr int kMaxTerms = 32;            // products in a rule's SOP, at most
constexpr int kLiterals = 5;             // b0, b1, b2, b3, x
constexpr unsigned kFull = 0xFFFFFFFFu;

}  // namespace

// The rule as data.  Term t is the AND over literals i of
// (lit[i] ^ flip[t][i]) | loose[t][i]: flip is all ones where the literal
// appears complemented, loose is all ones where the term ignores it.
struct Sop {
  int n_terms;
  uint32_t flip[kMaxTerms][kLiterals];
  uint32_t loose[kMaxTerms][kLiterals];
};

namespace {

__device__ __forceinline__ void csa(uint32_t a, uint32_t b, uint32_t c,
                                    uint32_t& sum, uint32_t& carry) {
  const uint32_t ab = a ^ b;
  sum = ab ^ c;
  carry = (a & b) | (ab & c);
}

__device__ __forceinline__ uint32_t apply_sop(const Sop& sop, uint32_t b0,
                                              uint32_t b1, uint32_t b2,
                                              uint32_t b3, uint32_t x) {
  const uint32_t lit[kLiterals] = {b0, b1, b2, b3, x};
  uint32_t out = 0;
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t >= sop.n_terms) break;
    uint32_t term = kFull;
#pragma unroll
    for (int i = 0; i < kLiterals; ++i) {
      term &= (lit[i] ^ sop.flip[t][i]) | sop.loose[t][i];
    }
    out |= term;
  }
  return out;
}

__global__ void __launch_bounds__(kLanes * kWarps)
packed_stripe_kernel(const uint32_t* __restrict__ src,
                     uint32_t* __restrict__ dst, int height, int nwords,
                     int rem_bits, int k, int tile_rows, const Sop sop) {
  extern __shared__ uint32_t smem[];
  const int ext = tile_rows + 2 * k;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + ext * kLanes;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int row0 = static_cast<int>(blockIdx.y) * tile_rows - k;  // smem row 0
  const int gw = static_cast<int>(blockIdx.x) * kInterior - 1 + lane;
  const bool col_in = gw >= 0 && gw < nwords;
  uint32_t cmask = col_in ? kFull : 0u;
  if (rem_bits && gw == nwords - 1) cmask = (1u << rem_bits) - 1u;

  for (int r = warp; r < ext; r += kWarps) {
    const int gr = row0 + r;
    uint32_t v = 0;
    if (col_in && gr >= 0 && gr < height) {
      v = src[static_cast<size_t>(gr) * nwords + gw];
    }
    cur[r * kLanes + lane] = v;
  }
  __syncthreads();

  for (int s = 1; s <= k; ++s) {
    const int n = ext - 2 * s;
    const int r_begin = s + (n * warp) / kWarps;
    const int r_end = s + (n * (warp + 1)) / kWarps;
    if (r_begin < r_end) {  // uniform across the warp
      uint32_t up = cur[(r_begin - 1) * kLanes + lane];
      uint32_t mid = cur[r_begin * kLanes + lane];
      for (int r = r_begin; r < r_end; ++r) {
        const uint32_t down = cur[(r + 1) * kLanes + lane];
        uint32_t ones, twos;
        csa(up, mid, down, ones, twos);
        uint32_t ones_l = __shfl_up_sync(kFull, ones, 1);
        uint32_t twos_l = __shfl_up_sync(kFull, twos, 1);
        uint32_t ones_r = __shfl_down_sync(kFull, ones, 1);
        uint32_t twos_r = __shfl_down_sync(kFull, twos, 1);
        if (lane == 0) ones_l = twos_l = 0;          // left of the tile
        if (lane == kLanes - 1) ones_r = twos_r = 0;  // right of the tile
        // L[c] = v[c-1]: (v << 1) | (left word >> 31); R[c] = v[c+1]
        const uint32_t o_l = __funnelshift_l(ones_l, ones, 1);
        const uint32_t o_r = __funnelshift_r(ones, ones_r, 1);
        const uint32_t t_l = __funnelshift_l(twos_l, twos, 1);
        const uint32_t t_r = __funnelshift_r(twos, twos_r, 1);
        uint32_t b0, c1, s1, c2;
        csa(o_l, ones, o_r, b0, c1);
        csa(t_l, twos, t_r, s1, c2);
        const uint32_t b1 = c1 ^ s1;
        const uint32_t u2 = c1 & s1;
        const uint32_t b2 = c2 ^ u2;
        const uint32_t b3 = c2 & u2;
        const int gr = row0 + r;
        const uint32_t m = (gr >= 0 && gr < height) ? cmask : 0u;
        nxt[r * kLanes + lane] = apply_sop(sop, b0, b1, b2, b3, mid) & m;
        up = mid;
        mid = down;
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (lane >= 1 && lane <= kInterior && col_in) {
    for (int r = k + warp; r < k + tile_rows; r += kWarps) {
      const int gr = row0 + r;
      if (gr < height) dst[static_cast<size_t>(gr) * nwords + gw] = cur[r * kLanes + lane];
    }
  }
}

}  // namespace

extern "C" {

// k masked steps from src into dst (distinct int32[height, nwords] buffers
// on the current device), on `stream`.  Returns cudaGetLastError().
int packed_stripe_multi_step(const void* src, void* dst, int height,
                             int nwords, int rem_bits, int k, int tile_rows,
                             const Sop* sop, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(tile_rows + 2 * k) * kLanes *
                      sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      packed_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kLanes, kWarps);
  const dim3 grid((nwords + kInterior - 1) / kInterior,
                  (height + tile_rows - 1) / tile_rows);
  packed_stripe_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), height,
      nwords, rem_bits, k, tile_rows, *sop);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
