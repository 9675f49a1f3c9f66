// Bit-sliced multi-step kernels for Hopper (sm_90a): the life-like Moore
// step and the von Neumann diamond.
//
// Replaces the TPU kernel make_pallas_packed_multi_step with its body
// _packed_tile_advance (tpu_life/backends/pallas_backend.py): the Moore mode
// by packed_stripe_kernel, the diamond mode (the branch of that body that
// plugs shift-by-k planes into bitlife.make_packed_diamond_step) by
// packed_diamond_kernel further down.  Each computes `k` masked steps of a
// packed bitboard, each step equal to bitlife.make_masked_packed_step on the
// whole board: 32 cells per 32-bit word, bit b of word j is column 32*j + b,
// int32[H, ceil(W/32)] with no frame.  Cells outside rows [0, H) or past
// column W are dead.
//
// The Moore mode.  Layout of one block: an output tile of tile_rows rows x kInterior words,
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
//
// The diamond mode (2 states, radius R of 1 or 2, with or without the centre
// in the count).  The same tiles, ping-pong and store; what differs:
// - a substep reaches R rows and R cells, so the row halo is R*k, substep s
//   recomputes rows [R*s, ext - R*s), and the one-word halo covers
//   R*k <= 32: the wrapper clamps k to 32 / R;
// - the diamond is a stack of 2R+1 horizontal boxes of half-width R - |dy|
//   and does not separate into a vertical and a horizontal pass.  A thread
//   takes the left and right neighbour words of the RAW row from the adjacent
//   lanes (two shuffles a row) and funnel-shifts them in by 1 and by 2.  At
//   R = 1 the count is up + down + L1 + R1 (+ x).  At R = 2 rows dy = +-2
//   give their own word, rows dy = +-1 the 3-wide box L1 + x + R1 as a
//   two-bit sum, and row dy = 0 the arms L1, R1, L2, R2 (+ x).  Walking down,
//   the thread keeps the boxes of rows r-1, r, r+1 and the arms of row r in
//   registers, so every row's box and shifts are formed once;
// - carry-save adds reduce the weighted planes to the raw count b0..b3
//   (at most 13), and the rule is boolmin.membership_rule_sop over that
//   count, in the same five-literal table: planes the count never reaches
//   are marked loose.
// What bounds it: integer instruction throughput, as in the Moore mode.  A
// word needs 4 funnel shifts, 9 carry-save adds and the rule at R = 2
// (logic_ops_per_word_step in kernels/packed_stripe.py), against 8 bytes of
// device-memory traffic per k steps; the halo recompute costs twice the
// Moore mode's rows for a given k, which the wrapper's tile height (four
// halos) keeps a minor share.

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

// The in-board bits of word column gw: all, none, or the low rem_bits of a
// partial last word.
__device__ __forceinline__ uint32_t column_mask(int gw, int nwords,
                                                int rem_bits) {
  if (gw < 0 || gw >= nwords) return 0u;
  if (rem_bits && gw == nwords - 1) return (1u << rem_bits) - 1u;
  return kFull;
}

// Load this thread's word column of the tile window (ext rows from board row
// row0) into shared memory; zero outside the board.
__device__ __forceinline__ void load_window(const uint32_t* __restrict__ src,
                                            uint32_t* cur, int ext, int row0,
                                            int gw, int height, int nwords) {
  const int lane = threadIdx.x;
  const bool col_in = gw >= 0 && gw < nwords;
  for (int r = threadIdx.y; r < ext; r += kWarps) {
    const int gr = row0 + r;
    uint32_t v = 0;
    if (col_in && gr >= 0 && gr < height) {
      v = src[static_cast<size_t>(gr) * nwords + gw];
    }
    cur[r * kLanes + lane] = v;
  }
}

// Store the tile's interior: window rows [halo, halo + tile_rows), lanes
// 1..kInterior, where they lie on the board.
__device__ __forceinline__ void store_interior(uint32_t* __restrict__ dst,
                                               const uint32_t* cur, int halo,
                                               int tile_rows, int row0, int gw,
                                               int height, int nwords) {
  const int lane = threadIdx.x;
  if (lane >= 1 && lane <= kInterior && gw >= 0 && gw < nwords) {
    for (int r = halo + threadIdx.y; r < halo + tile_rows; r += kWarps) {
      const int gr = row0 + r;
      if (gr < height) dst[static_cast<size_t>(gr) * nwords + gw] = cur[r * kLanes + lane];
    }
  }
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
  const uint32_t cmask = column_mask(gw, nwords, rem_bits);

  load_window(src, cur, ext, row0, gw, height, nwords);
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

  store_interior(dst, cur, k, tile_rows, row0, gw, height, nwords);
}

// What one raw row gives the diamond count: its arms, the planes of its left
// and right neighbours at distance 1 and 2, and its 3-wide box
// L1 + v + R1 as a two-bit sum (box_s weight 1, box_c weight 2).
struct RowPlanes {
  uint32_t l1, r1, l2, r2, box_s, box_c;
};

// Two shuffles bring the adjacent lanes' words of the same raw row; lanes 0
// and 31 are the tile's halo words and take zero from outside the tile.
template <int R>
__device__ __forceinline__ RowPlanes row_planes(uint32_t v, int lane) {
  uint32_t vl = __shfl_up_sync(kFull, v, 1);
  uint32_t vr = __shfl_down_sync(kFull, v, 1);
  if (lane == 0) vl = 0;
  if (lane == kLanes - 1) vr = 0;
  RowPlanes p;
  // L_d[c] = v[c-d]: (v << d) | (left word >> (32 - d)); R_d[c] = v[c+d]
  p.l1 = __funnelshift_l(vl, v, 1);
  p.r1 = __funnelshift_r(v, vr, 1);
  if constexpr (R == 2) {
    p.l2 = __funnelshift_l(vl, v, 2);
    p.r2 = __funnelshift_r(v, vr, 2);
    csa(p.l1, v, p.r1, p.box_s, p.box_c);
  } else {
    p.l2 = p.r2 = p.box_s = p.box_c = 0;
  }
  return p;
}

// k masked von Neumann steps of radius R (1 or 2) on the tile; `center` is
// all ones where the rule counts the centre cell (M1), else zero.
template <int R>
__global__ void __launch_bounds__(kLanes * kWarps)
packed_diamond_kernel(const uint32_t* __restrict__ src,
                      uint32_t* __restrict__ dst, int height, int nwords,
                      int rem_bits, int k, int tile_rows, uint32_t center,
                      const Sop sop) {
  extern __shared__ uint32_t smem[];
  const int halo = R * k;
  const int ext = tile_rows + 2 * halo;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + ext * kLanes;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int row0 = static_cast<int>(blockIdx.y) * tile_rows - halo;  // smem row 0
  const int gw = static_cast<int>(blockIdx.x) * kInterior - 1 + lane;
  const uint32_t cmask = column_mask(gw, nwords, rem_bits);

  load_window(src, cur, ext, row0, gw, height, nwords);
  __syncthreads();

  for (int s = 1; s <= k; ++s) {
    const int n = ext - 2 * R * s;
    const int r_begin = R * s + (n * warp) / kWarps;
    const int r_end = R * s + (n * (warp + 1)) / kWarps;
    if (r_begin < r_end) {  // uniform across the warp
      if constexpr (R == 1) {
        uint32_t up = cur[(r_begin - 1) * kLanes + lane];
        uint32_t mid = cur[r_begin * kLanes + lane];
        for (int r = r_begin; r < r_end; ++r) {
          const uint32_t down = cur[(r + 1) * kLanes + lane];
          const RowPlanes p = row_planes<1>(mid, lane);
          // count = up + down + L1 + R1 (+ x): at most 5
          uint32_t s0, c0, b0, c1;
          csa(up, down, p.l1, s0, c0);
          csa(s0, p.r1, mid & center, b0, c1);
          const uint32_t b1 = c0 ^ c1;
          const uint32_t b2 = c0 & c1;
          const int gr = row0 + r;
          const uint32_t m = (gr >= 0 && gr < height) ? cmask : 0u;
          nxt[r * kLanes + lane] = apply_sop(sop, b0, b1, b2, 0u, mid) & m;
          up = mid;
          mid = down;
        }
      } else {
        // raw rows r-2 .. r+1 and the planes of rows r-1 and r
        uint32_t up2 = cur[(r_begin - 2) * kLanes + lane];
        uint32_t up1 = cur[(r_begin - 1) * kLanes + lane];
        uint32_t mid = cur[r_begin * kLanes + lane];
        uint32_t dn1 = cur[(r_begin + 1) * kLanes + lane];
        RowPlanes above = row_planes<2>(up1, lane);
        RowPlanes here = row_planes<2>(mid, lane);
        for (int r = r_begin; r < r_end; ++r) {
          const uint32_t dn2 = cur[(r + 2) * kLanes + lane];
          const RowPlanes below = row_planes<2>(dn1, lane);
          // weight 1: the rows at dy = +-2, the four arms, the centre (M1)
          // and the two box sums; weight 2: the two box carries
          uint32_t s_a, c_a, s_b, c_b, s_c, c_c, b0, c_d;
          csa(up2, dn2, here.l1, s_a, c_a);
          csa(here.r1, here.l2, here.r2, s_b, c_b);
          csa(mid & center, above.box_s, below.box_s, s_c, c_c);
          csa(s_a, s_b, s_c, b0, c_d);
          uint32_t t_a, d_a, t_b, d_b;
          csa(c_a, c_b, c_c, t_a, d_a);
          csa(c_d, above.box_c, below.box_c, t_b, d_b);
          const uint32_t b1 = t_a ^ t_b;
          const uint32_t d_c = t_a & t_b;
          uint32_t b2, b3;
          csa(d_a, d_b, d_c, b2, b3);
          const int gr = row0 + r;
          const uint32_t m = (gr >= 0 && gr < height) ? cmask : 0u;
          nxt[r * kLanes + lane] = apply_sop(sop, b0, b1, b2, b3, mid) & m;
          up2 = up1;
          up1 = mid;
          mid = dn1;
          dn1 = dn2;
          above = here;
          here = below;
        }
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  store_interior(dst, cur, halo, tile_rows, row0, gw, height, nwords);
}

template <int R>
int launch_diamond(const void* src, void* dst, int height, int nwords,
                   int rem_bits, int k, int tile_rows, int center,
                   const Sop* sop, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(tile_rows + 2 * R * k) * kLanes *
                      sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      packed_diamond_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kLanes, kWarps);
  const dim3 grid((nwords + kInterior - 1) / kInterior,
                  (height + tile_rows - 1) / tile_rows);
  packed_diamond_kernel<R><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), height,
      nwords, rem_bits, k, tile_rows, center ? kFull : 0u, *sop);
  return static_cast<int>(cudaGetLastError());
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

// k masked von Neumann steps of `radius` 1 or 2 (k * radius <= 32), with the
// centre in the count where `center` is not 0; buffers and return value as
// above.  The Sop's literals are the raw count's planes b0..b3 and the cell.
int packed_diamond_multi_step(const void* src, void* dst, int height,
                              int nwords, int rem_bits, int k, int tile_rows,
                              int radius, int center, const Sop* sop,
                              void* stream) {
  if (radius == 1) {
    return launch_diamond<1>(src, dst, height, nwords, rem_bits, k, tile_rows,
                             center, sop, stream);
  }
  if (radius == 2) {
    return launch_diamond<2>(src, dst, height, nwords, rem_bits, k, tile_rows,
                             center, sop, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
