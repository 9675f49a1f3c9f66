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
//
// Kernel K3, the per-shard twin (sharded_stripe_kernel and
// sharded_diamond_kernel).  Replaces make_pallas_sharded_stripe_block
// (tpu_life/backends/pallas_backend.py) and its body _packed_tile_advance
// with a shard's row0.  It runs the same substeps (moore_block,
// diamond_block below) on one shard of a row-sharded board: the chunk
// int32[rows, nwords] of board rows [row0 + fr, row0 + fr + rows) and its
// halos top and bot of fr = R*k rows each, which arrive as three separate
// buffers (the halo exchange's outputs) and are stitched while the window
// loads, so no extended chunk is ever built.  What differs from K1 lies
// in the rows policy (ShardIo) the shared bodies take:
// - a window row v in [-fr, rows + fr) reads top[v + fr], chunk[v] or
//   bot[v - rows];
// - clamped, a row is live where its global row row0 + fr + v lies in
//   [0, height): the padding rows of the last shard and the zero halos at
//   the mesh ends stay dead;
// - on the torus (Moore only) every halo row is a real row, so no row is
//   masked, and the columns wrap at the logical width, which need not be a
//   multiple of 32.  Each lane that is not a plain word of the row (the
//   left halo of the first tile, the last word when it is partial, and the
//   lanes past it) loads the 32 cells that follow from its own column
//   modulo the width, stitched across the seam (wrapped_word).  Every lane
//   then holds real cells, the standard shifts and funnel shifts are exact
//   at the seam, nothing is masked during the substeps, and the store
//   clears the padding bits of the last word.
// What bounds it: as K1, integer issue, plus the 2*fr halo rows read per
// shard and block.

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

// The rows a block reads and writes, as a policy the shared bodies take.
// `row` counts from the board's row 0 (K1) or the chunk's row 0 (K3):
// - load(row, gw, nwords): the word at row `row`, word column gw;
// - live(row): whether the substeps keep the row's cells;
// - substep_cols(gw, ...): the bits the substeps keep in word column gw;
// - store(row, gw, ...): write an output word of word column gw, which is
//   on the board.

// K1: one board of `height` rows; zero outside it.
struct BoardIo {
  const uint32_t* src;
  uint32_t* dst;
  int height;

  __device__ __forceinline__ uint32_t load(int row, int gw, int nwords) const {
    if (gw >= 0 && gw < nwords && row >= 0 && row < height) {
      return src[static_cast<size_t>(row) * nwords + gw];
    }
    return 0u;
  }
  __device__ __forceinline__ bool live(int row) const { return row >= 0 && row < height; }
  __device__ __forceinline__ uint32_t substep_cols(int gw, int nwords, int rem_bits) const {
    return column_mask(gw, nwords, rem_bits);
  }
  __device__ __forceinline__ void store(int row, int gw, int nwords, int, uint32_t v) const {
    if (row < height) dst[static_cast<size_t>(row) * nwords + gw] = v;
  }
};

// `n` (1..32) cells of a packed row from column `col`, with col + n at most
// the row's width: the bits of one word or two.
__device__ __forceinline__ uint32_t row_bits(const uint32_t* row, int col, int n) {
  const int w = col >> 5;
  const int b = col & 31;
  uint32_t v = row[w] >> b;
  if (b + n > 32) v |= row[w + 1] << (32 - b);
  return n == 32 ? v : v & ((1u << n) - 1u);
}

// The 32 cells of a torus row from column 32 * gw modulo `width`: the
// virtual word gw of the row repeated without end in both directions.
__device__ __forceinline__ uint32_t wrapped_word(const uint32_t* row, int gw, int width) {
  int col = static_cast<int>((32LL * gw) % width);
  if (col < 0) col += width;
  uint32_t v = 0;
  for (int filled = 0; filled < 32; col = 0) {
    const int n = min(32 - filled, width - col);
    v |= row_bits(row, col, n) << filled;
    filled += n;
  }
  return v;
}

// K3: one shard.  Rows [0, rows) are the chunk, rows [-fr, 0) its top halo
// and [rows, rows + fr) its bottom halo; row v is board row row0 + fr + v.
template <bool Torus>
struct ShardIo {
  const uint32_t* top;
  const uint32_t* chunk;
  const uint32_t* bot;
  uint32_t* dst;
  int rows;    // the chunk's rows
  int fr;      // the halos' rows
  int row0;    // board row of top[0]
  int height;  // the board's rows (clamped mask)
  int width;   // the board's columns (torus wrap)

  __device__ __forceinline__ uint32_t load(int v, int gw, int nwords) const {
    const uint32_t* row;
    if (v < -fr || v >= rows + fr) return 0u;  // past the bottom halo: unused
    if (v < 0) {
      row = top + static_cast<size_t>(v + fr) * nwords;
    } else if (v < rows) {
      row = chunk + static_cast<size_t>(v) * nwords;
    } else {
      row = bot + static_cast<size_t>(v - rows) * nwords;
    }
    if constexpr (Torus) {
      if (gw >= 0 && (gw < nwords - 1 || (gw == nwords - 1 && width % 32 == 0))) {
        return row[gw];
      }
      return wrapped_word(row, gw, width);
    } else {
      return gw >= 0 && gw < nwords ? row[gw] : 0u;
    }
  }
  __device__ __forceinline__ bool live(int v) const {
    if constexpr (Torus) {
      return true;
    } else {
      const int g = row0 + fr + v;
      return g >= 0 && g < height;
    }
  }
  __device__ __forceinline__ uint32_t substep_cols(int gw, int nwords, int rem_bits) const {
    if constexpr (Torus) {
      return kFull;  // every lane holds real cells of the wrapped row
    } else {
      return column_mask(gw, nwords, rem_bits);
    }
  }
  __device__ __forceinline__ void store(int v, int gw, int nwords, int rem_bits,
                                        uint32_t x) const {
    if (v >= rows) return;
    if constexpr (Torus) x &= column_mask(gw, nwords, rem_bits);
    dst[static_cast<size_t>(v) * nwords + gw] = x;
  }
};

// Load this thread's word column of the tile window (ext rows from row
// row0) into shared memory.
template <class Io>
__device__ __forceinline__ void load_window(const Io& io, uint32_t* cur, int ext,
                                            int row0, int gw, int nwords) {
  const int lane = threadIdx.x;
  for (int r = threadIdx.y; r < ext; r += kWarps) {
    cur[r * kLanes + lane] = io.load(row0 + r, gw, nwords);
  }
}

// Store the tile's interior: window rows [halo, halo + tile_rows), lanes
// 1..kInterior, where they lie on the board.
template <class Io>
__device__ __forceinline__ void store_interior(const Io& io, const uint32_t* cur,
                                               int halo, int tile_rows, int row0,
                                               int gw, int nwords, int rem_bits) {
  const int lane = threadIdx.x;
  if (lane >= 1 && lane <= kInterior && gw >= 0 && gw < nwords) {
    for (int r = halo + threadIdx.y; r < halo + tile_rows; r += kWarps) {
      io.store(row0 + r, gw, nwords, rem_bits, cur[r * kLanes + lane]);
    }
  }
}

// k masked life-like steps of one tile, the body of K1's Moore mode and of
// K3's Moore modes.
template <class Io>
__device__ __forceinline__ void moore_block(const Io& io, int nwords, int rem_bits,
                                            int k, int tile_rows, const Sop& sop) {
  extern __shared__ uint32_t smem[];
  const int ext = tile_rows + 2 * k;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + ext * kLanes;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int row0 = static_cast<int>(blockIdx.y) * tile_rows - k;  // smem row 0
  const int gw = static_cast<int>(blockIdx.x) * kInterior - 1 + lane;
  const uint32_t cmask = io.substep_cols(gw, nwords, rem_bits);

  load_window(io, cur, ext, row0, gw, nwords);
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
        const uint32_t m = io.live(row0 + r) ? cmask : 0u;
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

  store_interior(io, cur, k, tile_rows, row0, gw, nwords, rem_bits);
}

__global__ void __launch_bounds__(kLanes * kWarps)
packed_stripe_kernel(const uint32_t* __restrict__ src,
                     uint32_t* __restrict__ dst, int height, int nwords,
                     int rem_bits, int k, int tile_rows, const Sop sop) {
  moore_block(BoardIo{src, dst, height}, nwords, rem_bits, k, tile_rows, sop);
}

template <bool Torus>
__global__ void __launch_bounds__(kLanes * kWarps)
sharded_stripe_kernel(const uint32_t* __restrict__ top,
                      const uint32_t* __restrict__ chunk,
                      const uint32_t* __restrict__ bot,
                      uint32_t* __restrict__ dst, int rows, int fr, int row0,
                      int height, int width, int nwords, int rem_bits, int k,
                      int tile_rows, const Sop sop) {
  moore_block(ShardIo<Torus>{top, chunk, bot, dst, rows, fr, row0, height, width},
              nwords, rem_bits, k, tile_rows, sop);
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

// k masked von Neumann steps of radius R (1 or 2) on the tile, the body of
// K1's and K3's diamond modes; `center` is all ones where the rule counts
// the centre cell (M1), else zero.
template <int R, class Io>
__device__ __forceinline__ void diamond_block(const Io& io, int nwords, int rem_bits,
                                              int k, int tile_rows, uint32_t center,
                                              const Sop& sop) {
  extern __shared__ uint32_t smem[];
  const int halo = R * k;
  const int ext = tile_rows + 2 * halo;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + ext * kLanes;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int row0 = static_cast<int>(blockIdx.y) * tile_rows - halo;  // smem row 0
  const int gw = static_cast<int>(blockIdx.x) * kInterior - 1 + lane;
  const uint32_t cmask = io.substep_cols(gw, nwords, rem_bits);

  load_window(io, cur, ext, row0, gw, nwords);
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
          const uint32_t m = io.live(row0 + r) ? cmask : 0u;
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
          const uint32_t m = io.live(row0 + r) ? cmask : 0u;
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

  store_interior(io, cur, halo, tile_rows, row0, gw, nwords, rem_bits);
}

template <int R>
__global__ void __launch_bounds__(kLanes * kWarps)
packed_diamond_kernel(const uint32_t* __restrict__ src,
                      uint32_t* __restrict__ dst, int height, int nwords,
                      int rem_bits, int k, int tile_rows, uint32_t center,
                      const Sop sop) {
  diamond_block<R>(BoardIo{src, dst, height}, nwords, rem_bits, k, tile_rows,
                   center, sop);
}

template <int R>
__global__ void __launch_bounds__(kLanes * kWarps)
sharded_diamond_kernel(const uint32_t* __restrict__ top,
                       const uint32_t* __restrict__ chunk,
                       const uint32_t* __restrict__ bot,
                       uint32_t* __restrict__ dst, int rows, int fr, int row0,
                       int height, int width, int nwords, int rem_bits, int k,
                       int tile_rows, uint32_t center, const Sop sop) {
  diamond_block<R>(ShardIo<false>{top, chunk, bot, dst, rows, fr, row0, height, width},
                   nwords, rem_bits, k, tile_rows, center, sop);
}

// Launch `kernel` over the tiles of `rows` x `nwords` words with a row halo
// of `halo` rows on each side; returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int rows, int nwords, int halo, int tile_rows,
           void* stream, Args... args) {
  const size_t smem = 2 * static_cast<size_t>(tile_rows + 2 * halo) * kLanes *
                      sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kLanes, kWarps);
  const dim3 grid((nwords + kInterior - 1) / kInterior,
                  (rows + tile_rows - 1) / tile_rows);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// k masked steps from src into dst (distinct int32[height, nwords] buffers
// on the current device), on `stream`.  Returns cudaGetLastError().
int packed_stripe_multi_step(const void* src, void* dst, int height,
                             int nwords, int rem_bits, int k, int tile_rows,
                             const Sop* sop, void* stream) {
  return launch(packed_stripe_kernel, height, nwords, k, tile_rows, stream,
                static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
                height, nwords, rem_bits, k, tile_rows, *sop);
}

// k masked von Neumann steps of `radius` 1 or 2 (k * radius <= 32), with the
// centre in the count where `center` is not 0; buffers and return value as
// above.  The Sop's literals are the raw count's planes b0..b3 and the cell.
int packed_diamond_multi_step(const void* src, void* dst, int height,
                              int nwords, int rem_bits, int k, int tile_rows,
                              int radius, int center, const Sop* sop,
                              void* stream) {
  const uint32_t c = center ? kFull : 0u;
  const auto* s = static_cast<const uint32_t*>(src);
  auto* d = static_cast<uint32_t*>(dst);
  if (radius == 1) {
    return launch(packed_diamond_kernel<1>, height, nwords, k, tile_rows, stream,
                  s, d, height, nwords, rem_bits, k, tile_rows, c, *sop);
  }
  if (radius == 2) {
    return launch(packed_diamond_kernel<2>, height, nwords, 2 * k, tile_rows, stream,
                  s, d, height, nwords, rem_bits, k, tile_rows, c, *sop);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel K3: k masked steps of one shard, from chunk (int32[rows, nwords],
// board rows [row0 + fr, row0 + fr + rows)) and its halos top and bot
// (int32[fr, nwords] each, fr = radius * k) into dst (int32[rows, nwords],
// not chunk), on `stream`.  mode 0: Moore, clamped to `height` rows; mode
// 1: Moore on the torus of `width` columns (rows are not masked); mode 2:
// the von Neumann diamond of `radius` 1 or 2, clamped, with the centre in
// the count where `center` is not 0.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these.
int sharded_stripe_block(const void* top, const void* chunk, const void* bot,
                         void* dst, int rows, int fr, int row0, int height,
                         int width, int k, int tile_rows, int mode, int radius,
                         int center, const Sop* sop, void* stream) {
  const int nwords = (width + 31) / 32;
  const int rem_bits = width % 32;
  const auto* t = static_cast<const uint32_t*>(top);
  const auto* c = static_cast<const uint32_t*>(chunk);
  const auto* b = static_cast<const uint32_t*>(bot);
  auto* d = static_cast<uint32_t*>(dst);
  const uint32_t ctr = center ? kFull : 0u;
  if (rows < 1 || width < 1 || k < 1 || fr != radius * k || radius * k > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == 0 && radius == 1) {
    return launch(sharded_stripe_kernel<false>, rows, nwords, fr, tile_rows, stream,
                  t, c, b, d, rows, fr, row0, height, width, nwords, rem_bits, k,
                  tile_rows, *sop);
  }
  if (mode == 1 && radius == 1) {
    return launch(sharded_stripe_kernel<true>, rows, nwords, fr, tile_rows, stream,
                  t, c, b, d, rows, fr, row0, height, width, nwords, rem_bits, k,
                  tile_rows, *sop);
  }
  if (mode == 2 && radius == 1) {
    return launch(sharded_diamond_kernel<1>, rows, nwords, fr, tile_rows, stream,
                  t, c, b, d, rows, fr, row0, height, width, nwords, rem_bits, k,
                  tile_rows, ctr, *sop);
  }
  if (mode == 2 && radius == 2) {
    return launch(sharded_diamond_kernel<2>, rows, nwords, fr, tile_rows, stream,
                  t, c, b, d, rows, fr, row0, height, width, nwords, rem_bits, k,
                  tile_rows, ctr, *sop);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
