// Bit-sliced multi-step kernels for Hopper (sm_90a): the life-like Moore
// step and the von Neumann diamond, on one board (K1) and on one shard (K3),
// and Conway's step on an int8 board (K5).
//
// Replaces three TPU kernels:
// - make_pallas_packed_multi_step with its body _packed_tile_advance (K1,
//   tpu_life/backends/pallas_backend.py): the Moore mode by
//   packed_stripe_kernel, the diamond mode (the branch of that body that
//   plugs shift-by-k planes into bitlife.make_packed_diamond_step) by
//   packed_diamond_kernel;
// - make_pallas_sharded_stripe_block (K3, same file), the same body with a
//   shard's row0, by sharded_stripe_kernel (Moore, clamped or torus) and
//   sharded_diamond_kernel;
// - conway_pallas / make_kernel with its substep _life_substep (K5,
//   experiments/pallas_bench.py) by conway_int8_kernel: the Moore tiles
//   with Conway's rule compiled in, on a board of one int8 byte a cell
//   that the rows policy (Int8Io) packs to bits as it loads and unpacks as
//   it stores.
// K1 and K3 compute `k` masked steps of a packed bitboard, each step equal to
// bitlife.make_masked_packed_step on the whole board: 32 cells per 32-bit
// word, bit b of word j is column 32*j + b, int32[H, ceil(W/32)] with no
// frame.  Cells outside rows [0, H) or past column W are dead.
//
// What bounds it on an H100: integer issue.  A word needs about 15 32-bit
// logic instructions a step for Conway (one LOP3 for any three-input
// function: carry-save adds 6, funnel shifts 4, total planes 2, rule 3;
// logic_ops_per_word_step in kernels/packed_stripe.py) and 26 for the
// diamond at radius 2, against 8 bytes of device memory per k steps (at
// k = 8, 16384^2 moves 64 MiB per 8 steps, about 20 us at 3.35 TB/s,
// against about 60 us of integer issue at 64 results per clock and SM).
// So the design spends as few instructions beyond those as it can, and
// keeps every row in registers.
//
// The tiles.  A warp owns a strip of 32 word columns, one word a lane:
// lanes 1..30 are its output words, lanes 0 and 31 the words beside them.
// A substep reaches r cells sideways (r the radius), so after k <= 32 / r
// substeps the wrong bits that lanes 0 and 31 take from outside the strip
// (a shuffle past the warp's edge returns the lane's own word) have not
// reached lanes 1 and 30: no lane is zeroed.  Down the strip, a block of up
// to 32 warps keeps a tile in registers, R rows a warp (4 or 8, an
// instance each): its output rows and r*k halo rows at each end.  Every
// substep computes all of them at once (the rows of a warp interleave),
// each warp taking the r rows beside its own from the warps above and
// below through shared memory: two r-row edges a warp, two buffers, one
// barrier a substep.  Each row is loaded once and stored once.  The halo is
// recomputed for every tile, but the critical path is k substeps of a
// warp's R rows, and the wrapper sizes the tiles to the board
// (packed_stripe.tile_shape): on a board too small to fill the card, four
// rows a warp and the tile that puts the fewest warps on a warp scheduler;
// on a larger one, eight rows a warp and the fewest warps whose halo is at
// most a sixth of their rows, so that several blocks share an SM and hide
// each other's loads.  (A wavefront that walks runs of rows with the k
// substeps as levels in registers recomputes less halo, but walks 2rk + k
// steps in order before its first row and keeps k levels of state; on the
// H100 it was slower than these tiles at every shape measured, PERF.md.)
//
// The rule.  The Moore mode has an instance with Conway's sum of products
// compiled in (boolmin.rule_sop's ((7, 3), (23, 20)): b0 b1 ~b2 | x ~b0
// ~b1 b2, the rule of the reference contract), which the wrapper picks by
// comparing a rule's minimized SOP with Conway's; every other rule comes
// as data (DataRule): the minimized SOP, each term the AND over the five
// literals of (lit ^ flip) | loose, terms 0 and 1 without a branch and any
// further terms in a loop, so one build serves every rule.  The diamond's
// literals are the raw count's planes b0..b3 (boolmin.membership_rule_sop)
// and the cell.
//
// The diamond (2 states, radius R of 1 or 2, with or without the centre in
// the count) is a stack of 2R+1 horizontal boxes of half-width R - |dy| and
// does not separate into a vertical and a horizontal pass.  A row takes the
// left and right neighbour words of the raw row from the adjacent lanes
// (two shuffles) and funnel-shifts them in by 1 and by 2.  At R = 1 the
// count is up + down + L1 + R1 (+ x).  At R = 2 rows dy = +-2 give their
// own word, rows dy = +-1 the 3-wide box L1 + x + R1 as a two-bit sum, and
// row dy = 0 the arms L1, R1, L2, R2 (+ x).  Carry-save adds reduce the
// weighted planes to the raw count b0..b3 (at most 13).
//
// Kernel K3 runs the same tiles on one shard of a row-sharded board: the
// chunk int32[rows, nwords] of board rows [row0 + fr, row0 + fr + rows)
// and its halos top and bot of fr = R*k rows each, three separate buffers
// (the halo exchange's outputs) stitched as the rows load, so no extended
// chunk is ever built.  What differs from K1 lies in the rows policy
// (ShardIo) the tiles take:
// - a row v in [-fr, rows + fr) reads top[v + fr], chunk[v] or
//   bot[v - rows];
// - clamped, a row is live where its global row row0 + fr + v lies in
//   [0, height): the padding rows of the last shard and the zero halos at
//   the mesh ends stay dead;
// - on the torus (Moore only) every halo row is a real row, so no row is
//   masked, and the columns wrap at the logical width, which need not be a
//   multiple of 32.  Each lane that is not a plain word of the row (lane 0
//   of the first strip, the last word when it is partial, and the lanes
//   past it) loads the 32 cells that follow from its own column modulo the
//   width, stitched across the seam (wrapped_word).  Every lane then holds
//   real cells, the shifts are exact at the seam, nothing is masked during
//   the substeps, and the store clears the padding bits of the last word.
//
// Kernel K5 computes k clamped Conway steps of a contiguous int8[n, n]
// board of cells 0 and 1 (another value is not valid input) in one launch,
// what the TPU kernel computes on its domain.  Its bound on an H100 is the
// bytes, one read and one write a cell a launch (2n^2 bytes against about
// half an instruction a cell and step bit-sliced).  So it runs K1's tiles
// unchanged and differs only in its rows policy (Int8Io): a lane loads the
// 32 bytes of its word column and packs them to the word's bits, 4 bytes
// by a multiply and a shift; the store unpacks each 4 bits by a multiply
// and a mask.  The loads and stores are the widest the row's alignment
// allows (16, 8 or 4 bytes, else single bytes), two 16-byte loads a lane
// at a 32-byte stride, read through L1.  The masks are K1's, applied after
// every substep: the TPU kernel's row mask (`valid`) and column mask.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;               // word columns of a strip: one a lane
constexpr int kInterior = kLanes - 2;    // output words of a strip: lanes 1..30
constexpr int kTileWarps = 32;           // warps of a tile's block, at most
constexpr int kMaxTerms = 32;            // products in a rule's SOP, at most
constexpr int kLiterals = 5;             // b0, b1, b2, b3, x
constexpr unsigned kFull = 0xFFFFFFFFu;
// K5's bytes to bits and back, 4 cells at a time (Int8Io)
constexpr uint32_t kPackMul = 0x01020408u;    // byte b to bit 24 + b
constexpr uint32_t kUnpackMul = 0x00204081u;  // bit b to bit 8b
constexpr uint32_t kByteOnes = 0x01010101u;

}  // namespace

// The rule as data.  Term t is the AND over literals i of
// (lit[i] ^ flip[t][i]) | loose[t][i]: flip is all ones where the literal
// appears complemented, loose all ones where the term ignores it.  Terms 0
// and 1 are always read: the wrapper fills them for SOPs of fewer terms.
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

// Conway (B3/S23) compiled in: over the 3x3 total's planes and the cell,
// b0 b1 ~b2 | x ~b0 ~b1 b2 (boolmin.rule_sop's ((7, 3), (23, 20))).
struct ConwayRule {
  __device__ __forceinline__ explicit ConwayRule(const Sop&) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t b0, uint32_t b1, uint32_t b2,
                                                 uint32_t, uint32_t x) const {
    return (b0 & b1 & ~b2) | (x & b2 & ~(b0 | b1));
  }
};

// Any rule as data: term t is the AND over the literals of (lit ^ flip) |
// loose, two LOP3 a literal.  Terms 0 and 1 are always evaluated (the
// table repeats term 0 where the SOP has one term), with no branch; Many:
// the SOP has more, and a loop takes the rest.  The loop splits a
// substep's rows into blocks that cannot interleave, so the tiles run it
// only for such rules (tile_kernel_body).
template <bool Many>
struct DataRule {
  const Sop& sop;
  __device__ __forceinline__ explicit DataRule(const Sop& s) : sop(s) {}
  __device__ __forceinline__ uint32_t term(int t, uint32_t b0, uint32_t b1, uint32_t b2,
                                           uint32_t b3, uint32_t x) const {
    const uint32_t(&f)[kLiterals] = sop.flip[t];
    const uint32_t(&l)[kLiterals] = sop.loose[t];
    return ((b0 ^ f[0]) | l[0]) & ((b1 ^ f[1]) | l[1]) & ((b2 ^ f[2]) | l[2]) &
           ((b3 ^ f[3]) | l[3]) & ((x ^ f[4]) | l[4]);
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t b0, uint32_t b1, uint32_t b2,
                                                 uint32_t b3, uint32_t x) const {
    uint32_t out = term(0, b0, b1, b2, b3, x) | term(1, b0, b1, b2, b3, x);
    if constexpr (Many) {
#pragma unroll 1
      for (int t = 2; t < sop.n_terms; ++t) out |= term(t, b0, b1, b2, b3, x);
    }
    return out;
  }
};

// One substep over a warp's R rows: rows(x, out, ...) takes rows -r ..
// R+r-1 of the board as it stands in x and writes the new rows 0 .. R-1 to
// out, before the board mask; cell(...) makes one row.  The rows of a
// substep are independent, so their instructions interleave.

// The Moore neighbourhood: the 3x3 total, its planes b0..b3, and the rule.
struct MooreSubstep {
  static constexpr int kReach = 1;

  template <class Rule>
  static __device__ __forceinline__ uint32_t cell(uint32_t up, uint32_t mid, uint32_t down,
                                                  const Rule& rule) {
    uint32_t ones, twos;
    csa(up, mid, down, ones, twos);
    const uint32_t ones_l = __shfl_up_sync(kFull, ones, 1);
    const uint32_t twos_l = __shfl_up_sync(kFull, twos, 1);
    const uint32_t ones_r = __shfl_down_sync(kFull, ones, 1);
    const uint32_t twos_r = __shfl_down_sync(kFull, twos, 1);
    // L[c] = v[c-1]: (v << 1) | (left word >> 31); R[c] = v[c+1]
    const uint32_t o_l = __funnelshift_l(ones_l, ones, 1);
    const uint32_t o_r = __funnelshift_r(ones, ones_r, 1);
    const uint32_t t_l = __funnelshift_l(twos_l, twos, 1);
    const uint32_t t_r = __funnelshift_r(twos, twos_r, 1);
    uint32_t b0, c1, s1, c2;
    csa(o_l, ones, o_r, b0, c1);
    csa(t_l, twos, t_r, s1, c2);
    return rule(b0, c1 ^ s1, c2 ^ (c1 & s1), c2 & c1 & s1, mid);
  }
  template <int R, class Rule>
  static __device__ __forceinline__ void rows(const uint32_t (&x)[R + 2], uint32_t (&out)[R],
                                              const Rule& rule, uint32_t) {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = cell(x[i], x[i + 1], x[i + 2], rule);
  }
};

// The diamond at radius 1: count = up + down + L1 + R1 (+ x), at most 5.
struct Diamond1Substep {
  static constexpr int kReach = 1;

  template <class Rule>
  static __device__ __forceinline__ uint32_t cell(uint32_t up, uint32_t mid, uint32_t down,
                                                  const Rule& rule, uint32_t center) {
    const uint32_t vl = __shfl_up_sync(kFull, mid, 1);
    const uint32_t vr = __shfl_down_sync(kFull, mid, 1);
    const uint32_t l1 = __funnelshift_l(vl, mid, 1);
    const uint32_t r1 = __funnelshift_r(mid, vr, 1);
    uint32_t s0, c0, b0, c1;
    csa(up, down, l1, s0, c0);
    csa(s0, r1, mid & center, b0, c1);
    return rule(b0, c0 ^ c1, c0 & c1, 0u, mid);
  }
  template <int R, class Rule>
  static __device__ __forceinline__ void rows(const uint32_t (&x)[R + 2], uint32_t (&out)[R],
                                              const Rule& rule, uint32_t center) {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = cell(x[i], x[i + 1], x[i + 2], rule, center);
  }
};

// The diamond at radius 2: row j's count from rows j-2 and j+2, the 3-wide
// boxes of rows j-1 and j+1, and row j's arms.
struct Diamond2Substep {
  static constexpr int kReach = 2;

  // the 3-wide box L1 + v + R1 of a row, as a two-bit sum
  static __device__ __forceinline__ void box(uint32_t v, uint32_t& s, uint32_t& cy) {
    const uint32_t vl = __shfl_up_sync(kFull, v, 1);
    const uint32_t vr = __shfl_down_sync(kFull, v, 1);
    csa(__funnelshift_l(vl, v, 1), v, __funnelshift_r(v, vr, 1), s, cy);
  }
  // row c's new cells from rows a (c-2) and e (c+2) and the boxes of the
  // rows beside c
  template <class Rule>
  static __device__ __forceinline__ uint32_t cell(uint32_t a, uint32_t c, uint32_t e,
                                                  uint32_t above_s, uint32_t above_c,
                                                  uint32_t below_s, uint32_t below_c,
                                                  const Rule& rule, uint32_t center) {
    const uint32_t cl = __shfl_up_sync(kFull, c, 1);
    const uint32_t cr = __shfl_down_sync(kFull, c, 1);
    // L_d[c] = v[c-d]: (v << d) | (left word >> (32 - d)); R_d[c] = v[c+d]
    const uint32_t l1 = __funnelshift_l(cl, c, 1);
    const uint32_t r1 = __funnelshift_r(c, cr, 1);
    const uint32_t l2 = __funnelshift_l(cl, c, 2);
    const uint32_t r2 = __funnelshift_r(c, cr, 2);
    // weight 1: the rows at dy = +-2, the four arms, the centre (M1) and
    // the two box sums; weight 2: the two box carries
    uint32_t s_a, c_a, s_b, c_b, s_c, c_c, b0, c_d;
    csa(a, e, l1, s_a, c_a);
    csa(r1, l2, r2, s_b, c_b);
    csa(c & center, above_s, below_s, s_c, c_c);
    csa(s_a, s_b, s_c, b0, c_d);
    uint32_t t_a, d_a, t_b, d_b;
    csa(c_a, c_b, c_c, t_a, d_a);
    csa(c_d, above_c, below_c, t_b, d_b);
    uint32_t b2, b3;
    csa(d_a, d_b, t_a & t_b, b2, b3);
    return rule(b0, t_a ^ t_b, b2, b3, c);
  }
  template <int R, class Rule>
  static __device__ __forceinline__ void rows(const uint32_t (&x)[R + 4], uint32_t (&out)[R],
                                              const Rule& rule, uint32_t center) {
    // the boxes of rows i-1, i and i+1 as row i is made: three pairs live,
    // not all R + 2
    uint32_t above_s, above_c, here_s, here_c;
    box(x[1], above_s, above_c);
    box(x[2], here_s, here_c);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      uint32_t below_s, below_c;
      box(x[i + 3], below_s, below_c);
      out[i] = cell(x[i], x[i + 2], x[i + 4], above_s, above_c, below_s, below_c, rule, center);
      above_s = here_s;
      above_c = here_c;
      here_s = below_s;
      here_c = below_c;
    }
  }
};

// The in-board bits of word column gw: all, none, or the low rem_bits of a
// partial last word.
__device__ __forceinline__ uint32_t column_mask(int gw, int nwords, int rem_bits) {
  if (gw < 0 || gw >= nwords) return 0u;
  if (rem_bits && gw == nwords - 1) return (1u << rem_bits) - 1u;
  return kFull;
}

// The rows a tile reads and writes, as a policy the tile takes.  `row`
// counts from the board's row 0 (K1) or the chunk's row 0 (K3):
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
    if (v < -fr || v >= rows + fr) return 0u;  // past the halos: unused
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
      if (width % 32 == 0) return row[(gw % nwords + nwords) % nwords];  // whole words
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

// Four cells of bytes 0 and 1 (the first in the low byte) to four bits,
// the first in bit 0: the product's byte 3 is b0 + 2 b1 + 4 b2 + 8 b3, and
// no lower byte sums past 255 to carry into it.
__device__ __forceinline__ uint32_t pack4(uint32_t w) { return (w * kPackMul) >> 24; }

// Bits 0..3 of `nib` (the rest zero) to four bytes 0 and 1: the product
// holds nib at bits 0, 7, 14 and 21 without overlap, so bit b lands alone
// at 8b.
__device__ __forceinline__ uint32_t unpack4(uint32_t nib) { return (nib * kUnpackMul) & kByteOnes; }

// K5: one int8 board of n x n cells, word column gw being the bytes of
// columns 32 gw .. 32 gw + 31 of a row (fewer in a partial last word);
// zero outside it.  `vec`: the bytes a load or store moves (16, 8, 4 or 1),
// which divides n and the alignment of both boards.
struct Int8Io {
  const int8_t* src;
  int8_t* dst;
  int n;
  int vec;

  __device__ __forceinline__ uint32_t load(int row, int gw, int nwords) const {
    if (gw < 0 || gw >= nwords || row < 0 || row >= n) return 0u;
    const int8_t* p = src + static_cast<size_t>(row) * n + 32 * gw;
    const int count = min(32, n - 32 * gw);  // whole groups of vec bytes
    uint32_t v = 0;
    if (vec == 16) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (16 * c < count) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + c);
          v |= (pack4(q.x) | pack4(q.y) << 4 | pack4(q.z) << 8 | pack4(q.w) << 12) << (16 * c);
        }
      }
    } else if (vec == 8) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (8 * c < count) {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + c);
          v |= (pack4(q.x) | pack4(q.y) << 4) << (8 * c);
        }
      }
    } else if (vec == 4) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (4 * c < count) v |= pack4(__ldg(reinterpret_cast<const uint32_t*>(p) + c)) << (4 * c);
      }
    } else {
      for (int b = 0; b < count; ++b) v |= static_cast<uint32_t>(__ldg(p + b)) << b;
    }
    return v;
  }
  __device__ __forceinline__ bool live(int row) const { return row >= 0 && row < n; }
  __device__ __forceinline__ uint32_t substep_cols(int gw, int nwords, int rem_bits) const {
    return column_mask(gw, nwords, rem_bits);
  }
  __device__ __forceinline__ void store(int row, int gw, int nwords, int rem_bits,
                                        uint32_t v) const {
    if (row >= n) return;
    int8_t* p = dst + static_cast<size_t>(row) * n + 32 * gw;
    const int count = rem_bits && gw == nwords - 1 ? rem_bits : 32;
    if (vec == 16) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (16 * c < count) {
          const uint32_t h = v >> (16 * c);
          reinterpret_cast<uint4*>(p)[c] = make_uint4(unpack4(h & 0xFu), unpack4(h >> 4 & 0xFu),
                                                      unpack4(h >> 8 & 0xFu), unpack4(h >> 12 & 0xFu));
        }
      }
    } else if (vec == 8) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (8 * c < count) {
          const uint32_t h = v >> (8 * c);
          reinterpret_cast<uint2*>(p)[c] = make_uint2(unpack4(h & 0xFu), unpack4(h >> 4 & 0xFu));
        }
      }
    } else if (vec == 4) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (4 * c < count) reinterpret_cast<uint32_t*>(p)[c] = unpack4(v >> (4 * c) & 0xFu);
      }
    } else {
      for (int b = 0; b < count; ++b) p[b] = static_cast<int8_t>(v >> b & 1u);
    }
  }
};

// The rows a tile's warps share: each warp's first and last r rows, in two
// buffers that the substeps take in turns; one array a kernel, whatever
// rule its tiles run.
template <int r>
__device__ __forceinline__ auto tile_edges() -> uint32_t (*)[kTileWarps][2 * r][kLanes] {
  __shared__ uint32_t edge[2][kTileWarps][2 * r][kLanes];
  return edge;
}

// k masked steps of the tile of output rows [t0, t0 + tile_rows) of a
// strip (the block's), by the W warps of the block (W = blockDim / 32, at
// most kTileWarps).  Warp w keeps R rows (4 or 8), board rows t0 - r*k +
// w*R onwards, one register each; a substep computes them all, the
// r rows beside them coming from the warps above and below through shared
// memory (one barrier a substep).  A row keeps its new cells where it is
// live (on the board) and its columns are masked, so the rows and columns
// off the board stay zero.  The tile's first and last r*k rows are its
// halo: each substep spoils r more rows at each end (zeros from past the
// tile), and the output rows are the ones left.
template <int R, class Substep, class Rule, class Io>
__device__ __forceinline__ void tile_run(const Io& io, int rows, int nwords, int rem_bits, int k,
                                         int tile_rows, uint32_t center, const Sop& sop) {
  constexpr int r = Substep::kReach;
  auto edge = tile_edges<r>();
  const int w = static_cast<int>(threadIdx.x / kLanes);
  const int lane = static_cast<int>(threadIdx.x % kLanes);
  const int warps = static_cast<int>(blockDim.x / kLanes);
  const int strips = (nwords + kInterior - 1) / kInterior;
  const int t0 = static_cast<int>(blockIdx.x) / strips * tile_rows;
  const int gw = static_cast<int>(blockIdx.x) % strips * kInterior - 1 + lane;
  const int base = t0 - r * k + w * R;  // board row of v[0]
  const Rule rule(sop);
  const uint32_t cmask = io.substep_cols(gw, nwords, rem_bits);
  uint32_t v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = io.load(base + i, gw, nwords);
#pragma unroll 1
  for (int s = 0; s < k; ++s) {
    uint32_t(&mine)[2 * r][kLanes] = edge[s & 1][w];
#pragma unroll
    for (int j = 0; j < r; ++j) {
      mine[j][lane] = v[j];
      mine[r + j][lane] = v[R - r + j];
    }
    __syncthreads();
    uint32_t x[R + 2 * r];
#pragma unroll
    for (int j = 0; j < r; ++j) {
      x[j] = w > 0 ? edge[s & 1][w - 1][r + j][lane] : 0u;
      x[r + R + j] = w + 1 < warps ? edge[s & 1][w + 1][j][lane] : 0u;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) x[r + i] = v[i];
    Substep::template rows<R>(x, v, rule, center);
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] &= io.live(base + i) ? cmask : 0u;
  }
  if (lane >= 1 && lane <= kInterior && gw < nwords) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = base + i;
      if (row >= t0 && row < t0 + tile_rows && row < rows) io.store(row, gw, nwords, rem_bits, v[i]);
    }
  }
}

// The body of every kernel here: the rule of more than two SOP terms takes
// its loop (DataRule<true>), every other one none.
template <int R, class Substep, class Rule, class Io>
__device__ __forceinline__ void tile_kernel_body(const Io& io, int rows, int nwords, int rem_bits,
                                                 int k, int tile_rows, uint32_t center,
                                                 const Sop& sop) {
  if constexpr (std::is_same_v<Rule, DataRule<false>>) {
    if (sop.n_terms > 2) {
      tile_run<R, Substep, DataRule<true>>(io, rows, nwords, rem_bits, k, tile_rows, center, sop);
      return;
    }
  }
  tile_run<R, Substep, Rule>(io, rows, nwords, rem_bits, k, tile_rows, center, sop);
}

// Each kernel comes in two instances, of R = 4 and 8 rows a warp.
template <int R, class Rule>
__global__ void __launch_bounds__(kLanes * kTileWarps, 1)
packed_stripe_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int height,
                     int nwords, int rem_bits, int k, int tile_rows, uint32_t center,
                     const Sop sop) {
  tile_kernel_body<R, MooreSubstep, Rule>(BoardIo{src, dst, height}, height, nwords, rem_bits, k,
                                     tile_rows, center, sop);
}

template <int Radius, int R>
__global__ void __launch_bounds__(kLanes * kTileWarps, 1)
packed_diamond_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int height,
                      int nwords, int rem_bits, int k, int tile_rows, uint32_t center,
                      const Sop sop) {
  using Substep = std::conditional_t<Radius == 1, Diamond1Substep, Diamond2Substep>;
  tile_kernel_body<R, Substep, DataRule<false>>(BoardIo{src, dst, height}, height, nwords, rem_bits,
                                           k, tile_rows, center, sop);
}

template <bool Torus, int R, class Rule>
__global__ void __launch_bounds__(kLanes * kTileWarps, 1)
sharded_stripe_kernel(const uint32_t* __restrict__ top, const uint32_t* __restrict__ chunk,
                      const uint32_t* __restrict__ bot, uint32_t* __restrict__ dst, int rows,
                      int fr, int row0, int height, int width, int nwords, int rem_bits, int k,
                      int tile_rows, uint32_t center, const Sop sop) {
  tile_kernel_body<R, MooreSubstep, Rule>(
      ShardIo<Torus>{top, chunk, bot, dst, rows, fr, row0, height, width}, rows, nwords,
      rem_bits, k, tile_rows, center, sop);
}

template <int Radius, int R>
__global__ void __launch_bounds__(kLanes * kTileWarps, 1)
sharded_diamond_kernel(const uint32_t* __restrict__ top, const uint32_t* __restrict__ chunk,
                       const uint32_t* __restrict__ bot, uint32_t* __restrict__ dst, int rows,
                       int fr, int row0, int height, int width, int nwords, int rem_bits, int k,
                       int tile_rows, uint32_t center, const Sop sop) {
  using Substep = std::conditional_t<Radius == 1, Diamond1Substep, Diamond2Substep>;
  tile_kernel_body<R, Substep, DataRule<false>>(
      ShardIo<false>{top, chunk, bot, dst, rows, fr, row0, height, width}, rows, nwords,
      rem_bits, k, tile_rows, center, sop);
}

__constant__ Sop kNoSop;  // the table argument of a kernel whose rule is compiled in; never read

template <int R>
__global__ void __launch_bounds__(kLanes * kTileWarps, 1)
conway_int8_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst, int n, int nwords,
                   int rem_bits, int k, int tile_rows, int vec) {
  tile_kernel_body<R, MooreSubstep, ConwayRule>(Int8Io{src, dst, n, vec}, n, nwords, rem_bits, k,
                                                tile_rows, 0u, kNoSop);
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// f(the instance of `warp_rows` rows a warp, 4 or 8), else kInvalid.
template <class Pick>
int with_warp_rows(int warp_rows, Pick pick) {
  if (warp_rows == 4) return pick(std::integral_constant<int, 4>{});
  if (warp_rows == 8) return pick(std::integral_constant<int, 8>{});
  return kInvalid;
}

// Launch `kernel` over `rows` x `nwords` words, one block a tile of
// tile_rows output rows and a strip, of the warps that keep the tile and
// its halo of reach * k rows at each end, R rows a warp.  kInvalid where k
// is outside [1, 32 / reach] or the tile needs more than kTileWarps warps;
// else cudaGetLastError().
template <int R, typename Kernel, typename... Args>
int launch(Kernel kernel, int rows, int nwords, int tile_rows, int reach, int k, void* stream,
           Args... args) {
  if (rows < 1 || nwords < 1 || tile_rows < 1 || k < 1 || reach * k > 32) return kInvalid;
  const int warps = (tile_rows + 2 * reach * k + R - 1) / R;
  if (warps > kTileWarps) return kInvalid;
  const long long strips = (nwords + kInterior - 1) / kInterior;
  const dim3 grid(static_cast<unsigned>(strips * ((rows + tile_rows - 1) / tile_rows)));
  kernel<<<grid, kLanes * warps, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// k masked life-like steps from src into dst (distinct int32[height,
// nwords] buffers on the current device) in tiles of tile_rows output
// rows, warp_rows (4 or 8) rows a warp, on `stream`.  compiled != 0 runs
// the instance with Conway's rule built in (the rule must be Conway's),
// else the rule is `sop`.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for k outside [1, 32], another warp_rows or a tile
// too tall for one block.
int packed_stripe_multi_step(const void* src, void* dst, int height, int nwords, int rem_bits,
                             int k, int tile_rows, int warp_rows, int compiled, const Sop* sop,
                             void* stream) {
  const auto s = static_cast<const uint32_t*>(src);
  const auto d = static_cast<uint32_t*>(dst);
  return with_warp_rows(warp_rows, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    return compiled
               ? launch<R>(packed_stripe_kernel<R, ConwayRule>, height, nwords, tile_rows, 1, k,
                           stream, s, d, height, nwords, rem_bits, k, tile_rows, 0u, *sop)
               : launch<R>(packed_stripe_kernel<R, DataRule<false>>, height, nwords, tile_rows, 1,
                           k, stream, s, d, height, nwords, rem_bits, k, tile_rows, 0u, *sop);
  });
}

// k masked von Neumann steps of `radius` 1 or 2 (k * radius <= 32), with
// the centre in the count where `center` is not 0; buffers, tiles and
// return value as above.  The Sop's literals are the raw count's planes
// b0..b3 and the cell.
int packed_diamond_multi_step(const void* src, void* dst, int height, int nwords, int rem_bits,
                              int k, int tile_rows, int warp_rows, int radius, int center,
                              const Sop* sop, void* stream) {
  const auto s = static_cast<const uint32_t*>(src);
  const auto d = static_cast<uint32_t*>(dst);
  const uint32_t c = center ? kFull : 0u;
  return with_warp_rows(warp_rows, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    if (radius == 1) {
      return launch<R>(packed_diamond_kernel<1, R>, height, nwords, tile_rows, 1, k, stream, s, d,
                       height, nwords, rem_bits, k, tile_rows, c, *sop);
    }
    if (radius == 2) {
      return launch<R>(packed_diamond_kernel<2, R>, height, nwords, tile_rows, 2, k, stream, s, d,
                       height, nwords, rem_bits, k, tile_rows, c, *sop);
    }
    return kInvalid;
  });
}

// Kernel K3: k masked steps of one shard, from chunk (int32[rows, nwords],
// board rows [row0 + fr, row0 + fr + rows)) and its halos top and bot
// (int32[fr, nwords] each, fr = radius * k) into dst (int32[rows, nwords],
// not chunk), in tiles as above, on `stream`.  mode 0: Moore, clamped to
// `height` rows; mode 1: Moore on the torus of `width` columns (rows are
// not masked); mode 2: the von Neumann diamond of `radius` 1 or 2,
// clamped, with the centre in the count where `center` is not 0.
// compiled != 0 (modes 0 and 1) runs Conway's rule built in.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these.
int sharded_stripe_block(const void* top, const void* chunk, const void* bot, void* dst,
                         int rows, int fr, int row0, int height, int width, int k, int tile_rows,
                         int warp_rows, int mode, int radius, int center, int compiled,
                         const Sop* sop, void* stream) {
  if (rows < 1 || width < 1 || k < 1 || fr != radius * k || radius * k > 32) return kInvalid;
  const int nwords = (width + 31) / 32;
  const int rem_bits = width % 32;
  const uint32_t c = center ? kFull : 0u;
  const auto t = static_cast<const uint32_t*>(top);
  const auto m = static_cast<const uint32_t*>(chunk);
  const auto b = static_cast<const uint32_t*>(bot);
  const auto d = static_cast<uint32_t*>(dst);
  return with_warp_rows(warp_rows, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    auto go = [&](auto kernel) {
      return launch<R>(kernel, rows, nwords, tile_rows, radius, k, stream, t, m, b, d, rows, fr,
                       row0, height, width, nwords, rem_bits, k, tile_rows, c, *sop);
    };
    if (mode == 0 && radius == 1) {
      return compiled ? go(sharded_stripe_kernel<false, R, ConwayRule>)
                      : go(sharded_stripe_kernel<false, R, DataRule<false>>);
    }
    if (mode == 1 && radius == 1) {
      return compiled ? go(sharded_stripe_kernel<true, R, ConwayRule>)
                      : go(sharded_stripe_kernel<true, R, DataRule<false>>);
    }
    if (mode == 2 && radius == 1) return go(sharded_diamond_kernel<1, R>);
    if (mode == 2 && radius == 2) return go(sharded_diamond_kernel<2, R>);
    return kInvalid;
  });
}

// Kernel K5: k clamped Conway steps (1 <= k <= 32) from src into dst
// (distinct contiguous int8[n, n] boards of 0s and 1s on the current
// device), in tiles as above, on `stream`; loads and stores of 16, 8 or 4
// bytes where n and both boards' addresses are multiples of it, else of
// single bytes.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments outside these.
int conway_block_int8(const void* src, void* dst, int n, int k, int tile_rows, int warp_rows,
                      void* stream) {
  if (n < 1) return kInvalid;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                      static_cast<uintptr_t>(n);
  const int vec = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
  const auto s = static_cast<const int8_t*>(src);
  const auto d = static_cast<int8_t*>(dst);
  const int nwords = (n + 31) / 32;
  return with_warp_rows(warp_rows, [&](auto rc) {
    constexpr int R = decltype(rc)::value;
    return launch<R>(conway_int8_kernel<R>, n, nwords, tile_rows, 1, k, stream, s, d, n, nwords,
                     n % 32, k, tile_rows, vec);
  });
}

}  // extern "C"
