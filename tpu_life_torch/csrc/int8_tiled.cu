// Int8 tiled multi-step kernels for Hopper (sm_90a): kernels K2 and K4.
//
// K2 replaces the TPU kernel make_pallas_multi_step with its bodies
// _vmem_counts and _int8_substeps and the frame re-zeroing _zero_frame
// (tpu_life/backends/pallas_backend.py).  It computes `k` masked steps of
// an unframed, contiguous int8[H, W] board of states 0 .. C-1, each equal
// to stencil.make_masked_step(rule, (H, W)) of tpu_life_torch/ops/stencil.py
// on the whole board, for any clamped Moore rule: radius 1 <= r <= 127, the
// centre counted or not, 2 to 10 states.  Only state 1 is alive; the dying
// states of Generations count as dead.  Cells outside the board are dead
// and stay dead.  A cell holding a state outside 0 .. C-1 is not valid
// input.
//
// K4 replaces the TPU kernel make_pallas_sharded_int8_block (same file): K2
// per shard of the sharded backend.  It computes the same `k` masked steps
// of one shard's chunk, int8[rows, cols] holding the board's cells from
// board coordinate (row_org, col_org), from the chunk and its halos, which
// the exchange of parallel/halo.py filled from the neighbouring shards:
// `top` and `bot` (fr = r*k rows of the chunk's width each) and, on a mesh
// of columns, `left` and `right` (fr + rows + fr rows of fc = r*k columns
// each, corners included).  K4 reads the pieces where they lie, so no block
// copies the chunk.  Cells of the board outside the chunk and its halos read
// zero; cells off the board, among them the padding rows and columns of the
// last shards, are pinned dead by the same mask as K2's.
//
// The two share every substep (int8_tile, templated on the window's
// source): K2's source is the board (BoardSrc), K4's the chunk and its four
// halos (ShardSrc).
//
// What bounds it on an H100 (ops_per_cell_step in kernels/int8_tiled.py).
// At r = 1 the function runs bit-sliced, 32 cells a word, in 15-19 logic
// operations a word and step, so even at k = 8 it is bound by its 2 bytes of
// device memory a cell per launch; at r >= 2 it needs some seven 32-bit
// integer operations a cell and step, bound by its bytes at k = 1 (bugs,
// r = 5).  This kernel keeps four cells a word, not 32, so at r = 1 it
// issues several times the operations the bound counts.
// The design before this one made some eight shared-memory accesses a cell
// and substep, one byte or half-word each, and read the rule from a table
// in shared memory per cell; those accesses, not the arithmetic, set its
// pace.  This design:
//
// - keeps four cells a 32-bit word in shared memory.  A block loads an
//   output tile of tile_rows x tile_cols cells with a halo of h = r*k rows
//   above and below and `margin` = ceil16(h) columns on each side: a plane
//   of states and one of alive bits (one plane when C = 2, where the states
//   are the alive bits), each row a pitch of an odd number of 16-byte units
//   so that 16-byte accesses of consecutive rows fall in different banks.
// - every cell's index in the rule's bit set is its box sum + K * alive:
//   bit count + a*(max_count+1) of the set is set where a cell of state a
//   (0 or 1) with `count` live neighbours is alive next (the birth set,
//   then the survive set).  The set is data, so one build serves every
//   rule.
// - r >= 2, two passes a substep, with a plane of int8 vertical sums:
//   - vertical: a thread owns a word column and a segment of rows and keeps
//     the running sum of 2r+1 alive rows in byte lanes (one 32-bit load
//     entering, one leaving, one store of four sums a row); a sum is at
//     most 2r+1 <= 255, so no lane carries into the next.
//   - horizontal: a thread walks a run of four words along a row.  A box
//     sum, up to (2r+1)^2, does not fit a byte; each lane's is a 32-bit
//     running sum, to which dp4a adds the entering and from which it
//     subtracts the leaving vertical sums (read as words and realigned by
//     a funnel shift).  The set is read from shared memory, one word a
//     cell.  States and alive bits are written back in place: a cell's new
//     state depends on its own state and the sums only.
// - r = 1, one pass a substep: a thread walks a run of four words along a
//   row, adds the alive words of the rows above, at and below into vertical
//   sums (at most 3 a lane), and the box sums of four lanes at once (at most
//   9) from a word and its two funnel-shifted neighbours.  The alive bits
//   alternate between two planes (a pass reads its neighbours' from one and
//   writes its own to the other); the states (C > 2) are written in place.
//   The set's 18-20 bits live in registers, shifted left by 8b for lane b,
//   so that one funnel shift by the lane's index puts its bit at bit 8b.
// - the dying states follow by arithmetic on the four lanes at once: a
//   surviving bit of 0 turns state 1 into 2 (C > 2), state s >= 2 becomes
//   (s + 1) % C, with lane masks from byte permutes that replicate each
//   byte's sign.  The state words are read and written 16 bytes at a time.
// - the board mask is one mask per word: only the board's first and last
//   words can be partial.  It runs after every substep: a rule may give
//   birth just past the edge, and such a cell must not live to feed the
//   next substep's counts.
// - substep s computes only the rows and columns that the tile needs after
//   the k - s substeps still to come (a region that shrinks by r on every
//   side a substep), rounded out to 16 bytes; cells computed past it are
//   never read by a cell that is.  At 64 x 256 tiles and r*k = 8 the
//   substeps compute about 1.15x the tile's cells.
// - window loads are asynchronous copies (cp.async) of 16 bytes, or of 8 or
//   4 where a row's alignment allows no more; a copy past the board or the
//   halos asks for 0 source bytes and the hardware writes the zeros.  Only
//   a width that is not a multiple of 4 loads byte by byte.
//
// About 0.75 shared-memory accesses a cell and substep remain at r = 1 and 2-3
// at r >= 2 (the vertical pass, the running streams and the set's word),
// against 8.  What bounds the kernel now is the integer work a cell (the
// index, the set lookup, the byte assembly and the state arithmetic) and
// the halo.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kRun = 4;        // words a thread walks along a row, 16 cells
constexpr int kGuard = 32;     // bytes of shared memory before and after the sums

// -- inline PTX ---------------------------------------------------------------

// c + the dot product of a's unsigned and b's signed bytes
__device__ __forceinline__ uint32_t dp4a_us(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 0xFF in the bytes of x whose top bit is set, 0x00 elsewhere: a byte
// permute whose selectors replicate each byte's sign
__device__ __forceinline__ uint32_t top_bits(uint32_t x) {
  uint32_t d;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(d) : "r"(x));
  return d;
}

// An asynchronous copy of N bytes from global to shared memory; zeros where
// !valid (src is then not read, but must be a global address).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N),
                 "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- helpers ----------------------------------------------------------------

// f(i, j) for every item of an nrows x ncols grid, row-major, dealt
// round-robin to the block's threads
template <class F>
__device__ __forceinline__ void for_each_item(int nrows, int ncols, F f) {
  if (nrows <= 0 || ncols <= 0) return;
  int i = static_cast<int>(threadIdx.x) / ncols;
  int j = static_cast<int>(threadIdx.x) % ncols;
  const int di = kThreads / ncols;
  const int dj = kThreads % ncols;
  while (i < nrows) {
    f(i, j);
    i += di;
    j += dj;
    if (j >= ncols) {
      j -= ncols;
      ++i;
    }
  }
}

__device__ __forceinline__ int clamp_to(int x, int hi) { return min(max(x, 0), hi); }

// Window columns [c0, c1) of every window row (c0, c1 multiples of N):
// row i's column c from at(i) + c, zeros where at(i) is null.  any: a
// global address for the zero copies.
template <int N, class At>
__device__ __forceinline__ void copy_chunks(uint8_t* win, int pitch, int ext_r, int c0, int c1,
                                            const int8_t* any, At at) {
  for_each_item(ext_r, (c1 - c0) / N, [&](int i, int j) {
    const int c = c0 + j * N;
    const int8_t* g = at(i);
    cp_async<N>(win + i * pitch + c, g != nullptr ? g + c : any, g != nullptr);
  });
}

// The same with copies of io bytes (16, 8 or 4; else one byte at a time)
template <class At>
__device__ __forceinline__ void copy_span(uint8_t* win, int pitch, int ext_r, int c0, int c1,
                                          int io, const int8_t* any, At at) {
  if (c1 <= c0) return;
  switch (io) {
    case 16:
      copy_chunks<16>(win, pitch, ext_r, c0, c1, any, at);
      break;
    case 8:
      copy_chunks<8>(win, pitch, ext_r, c0, c1, any, at);
      break;
    case 4:
      copy_chunks<4>(win, pitch, ext_r, c0, c1, any, at);
      break;
    default:
      for_each_item(ext_r, c1 - c0, [&](int i, int j) {
        const int c = c0 + j;
        const int8_t* g = at(i);
        win[i * pitch + c] = g != nullptr ? static_cast<uint8_t>(g[c]) : 0;
      });
  }
}

__device__ __forceinline__ const int8_t* no_row(int) { return nullptr; }

// A window source loads ext_r x ext_c cells into `win` (row pitch `pitch`):
// window cell (i, c) is the cell at output row grow0 + i, output column
// gcol0 + c (gcol0 a multiple of 16); the copies are asynchronous.

// K2: the board is the output; zero outside it.  io: bytes a copy (a power
// of two up to 16 that divides the width and the board's address).
struct BoardSrc {
  const int8_t* __restrict__ src;
  int height;
  int width;
  int io;

  __device__ __forceinline__ void load(uint8_t* win, int pitch, int grow0, int gcol0,
                                       int ext_r, int ext_c) const {
    auto at = [&](int i) -> const int8_t* {
      const int gr = grow0 + i;
      return gr >= 0 && gr < height ? src + static_cast<ptrdiff_t>(gr) * width + gcol0 : nullptr;
    };
    const int b0 = clamp_to(-gcol0, ext_c);
    const int b1 = clamp_to(width - gcol0, ext_c);
    copy_span(win, pitch, ext_r, 0, b0, io, src, no_row);
    copy_span(win, pitch, ext_r, b0, b1, io, src, at);
    copy_span(win, pitch, ext_r, b1, ext_c, io, src, no_row);
  }
};

// K4: one shard.  Chunk rows v in [0, rows) and columns u in [0, cols);
// row v of the extended chunk, v in [-fr, rows + fr), is top[v + fr],
// chunk[v] or bot[v - rows]; columns u in [-fc, 0) and [cols, cols + fc)
// are left[v + fr][u + fc] and right[v + fr][u - cols] (fc = 0: none).
// io: bytes a copy of the rows of top, chunk and bot (dividing cols);
// io_side: of left and right and of the zeros beside them (dividing fc and
// cols).
struct ShardSrc {
  const int8_t* __restrict__ top;
  const int8_t* __restrict__ chunk;
  const int8_t* __restrict__ bot;
  const int8_t* __restrict__ left;
  const int8_t* __restrict__ right;
  int rows;
  int cols;
  int fr;
  int fc;
  int io;
  int io_side;

  __device__ __forceinline__ void load(uint8_t* win, int pitch, int grow0, int gcol0,
                                       int ext_r, int ext_c) const {
    auto in = [&](int v) { return v >= -fr && v < rows + fr; };
    auto mid = [&](int i) -> const int8_t* {
      const int v = grow0 + i;
      if (!in(v)) return nullptr;
      const int8_t* row = v < 0      ? top + static_cast<ptrdiff_t>(v + fr) * cols
                          : v < rows ? chunk + static_cast<ptrdiff_t>(v) * cols
                                     : bot + static_cast<ptrdiff_t>(v - rows) * cols;
      return row + gcol0;
    };
    auto lft = [&](int i) -> const int8_t* {
      const int v = grow0 + i;
      return in(v) ? left + static_cast<ptrdiff_t>(v + fr) * fc + fc + gcol0 : nullptr;
    };
    auto rgt = [&](int i) -> const int8_t* {
      const int v = grow0 + i;
      return in(v) ? right + static_cast<ptrdiff_t>(v + fr) * fc - cols + gcol0 : nullptr;
    };
    const int zio = fc > 0 ? io_side : io;
    const int b0 = clamp_to(-fc - gcol0, ext_c);
    const int b1 = clamp_to(-gcol0, ext_c);
    const int b2 = clamp_to(cols - gcol0, ext_c);
    const int b3 = clamp_to(cols + fc - gcol0, ext_c);
    copy_span(win, pitch, ext_r, 0, b0, zio, chunk, no_row);
    copy_span(win, pitch, ext_r, b0, b1, io_side, chunk, lft);
    copy_span(win, pitch, ext_r, b1, b2, io, chunk, mid);
    copy_span(win, pitch, ext_r, b2, b3, io_side, chunk, rgt);
    copy_span(win, pitch, ext_r, b3, ext_c, zio, chunk, no_row);
  }
};

// The rule: bits[nwords], bit count + a*(max_count + 1) set where a cell of
// state a (0 or 1) with `count` live neighbours is alive next.
struct RuleArgs {
  const uint32_t* __restrict__ bits;
  int nwords;
  int radius;
  int k;
  int states;
  int center;  // 1: the count includes the cell itself
  int max_count;
};

// The block's layout in shared memory and where its tile goes: output
// int8[out_rows, out_cols], io bytes a store (dividing out_cols and dst's
// address); output cell (0, 0) is board cell (row_org, col_org) of a
// height x width board, for the mask.
struct Tiling {
  int tile_rows;
  int tile_cols;
  int margin;  // window columns on each side of the tile: ceil16(r*k)
  int ext_c;   // window columns: tile_cols + 2*margin
  int pitch;   // row pitch of the state and alive planes (16 * odd >= ext_c)
  int vpitch;  // row pitch of the sums (16 * odd >= ext_c + kGuard)
  int8_t* __restrict__ dst;
  int out_rows;
  int out_cols;
  int io;
  int row_org;
  int col_org;
  int height;
  int width;
};

// The rule in the form one word's update reads it
struct Sets {
  uint32_t tlo[4];        // r = 1: the bits shifted left by 8b, low and high
  uint32_t thi[4];        //   words (a funnel shift puts bit n at bit 8b)
  const uint32_t* table;  // r >= 2: the bits in shared memory
  uint32_t last;          //   nwords - 1
  uint32_t kmul;          // K: count + a*(max_count+1) = box sum + a*K
};

// Lanes that hold a state >= 2 (Generations' dying states), as 0xFF
__device__ __forceinline__ uint32_t dying(uint32_t st) { return top_bits(st + 0x7E7E7E7Eu); }

// 0xFF in the bytes of the word at board column bc that lie on the board
__device__ __forceinline__ uint32_t word_mask(int bc, int width) {
  if (bc >= 0 && bc + 4 <= width) return 0xFFFFFFFFu;
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (bc + b >= 0 && bc + b < width) m |= 0xFFu << (8 * b);
  }
  return m;
}

// One substep's horizontal pass: rows [lo_r, hi_r), words [hw0, hw1) (a
// multiple of kRun): the box sums, the rule, the board mask.  The states
// are read from `in` and written to `out`, the alive bits (C > 2) to `al`.
// kR1: the radius is 1, and `sums` is the plane of alive bits that the
// vertical sums of three rows are taken from (pitch t.pitch); else `sums`
// is the plane of vertical sums (pitch t.vpitch), the box sums a running
// sum and the set in shared memory.
template <bool kR1, bool kMulti>
__device__ __forceinline__ void horizontal(const Sets& rs, const RuleArgs& rule, const Tiling& t,
                                           const uint8_t* in, uint8_t* out, uint8_t* al,
                                           const uint8_t* sums, int lo_r, int hi_r, int hw0,
                                           int hw1, int grow0, int gcol0) {
  const int r = rule.radius;
  const int el = r & 3;             // the entering lanes' offset from a word
  const int ll = (-r - 1) & 3;      // the leaving lanes'
  const int ew = r >> 2;            // words from a cell's word to its entering word
  const int lw = (-r - 1) >> 2;     // to its leaving word (floor)
  // lanes where s + 1 reaches C get the top bit from s + wrap
  const uint32_t wrap = (0x81u - static_cast<uint32_t>(rule.states)) * 0x01010101u;
  for_each_item(hi_r - lo_r, (hw1 - hw0) / kRun, [&](int ii, int j) {
    const int i = lo_r + ii;
    const int w0 = hw0 + j * kRun;
    const uint32_t* vrow = reinterpret_cast<const uint32_t*>(sums + i * t.vpitch);
    // r = 1: the vertical sums of the run's words and of one word on each
    // side, from the alive bits of rows i - 1, i and i + 1; else the
    // running sum over sums [4*w0 - r - 1, 4*w0 + r - 1] (the window of the
    // cell before the run) and the entering and leaving streams
    uint32_t v[kRun + 2];
    uint32_t S = 0;
    const uint32_t* ev = vrow + w0 + ew;
    const uint32_t* lv = vrow + w0 + lw;
    uint32_t e_lo = 0;
    uint32_t l_lo = 0;
    if constexpr (kR1) {
      const uint32_t* a = reinterpret_cast<const uint32_t*>(sums + (i - 1) * t.pitch) + w0;
#pragma unroll
      for (int d = 0; d < 3; ++d, a += t.pitch / 4) {
        const uint4 c = *reinterpret_cast<const uint4*>(a);
        const uint32_t x[kRun + 2] = {a[-1], c.x, c.y, c.z, c.w, a[kRun]};
#pragma unroll
        for (int q = 0; q < kRun + 2; ++q) v[q] = d == 0 ? x[q] : v[q] + x[q];
      }
    } else {
      const int p0 = 4 * w0 - r - 1;
      const int p1 = 4 * w0 + r - 1;
      const int a0 = p0 >> 2;
      const int a1 = p1 >> 2;
      const uint32_t m0 = 0x01010101u << (8 * (p0 & 3));
      const uint32_t m1 = 0x01010101u >> (8 * (3 - (p1 & 3)));
      for (int a = a0; a <= a1; ++a) {
        uint32_t m = 0x01010101u;
        if (a == a0) m &= m0;
        if (a == a1) m &= m1;
        S = __dp4a(vrow[a], m, S);
      }
      e_lo = ev[0];
      l_lo = lv[0];
    }
    const uint4 sw = *reinterpret_cast<const uint4*>(in + i * t.pitch + 4 * w0);
    const uint32_t sv[kRun] = {sw.x, sw.y, sw.z, sw.w};
    uint32_t ov[kRun];
    uint32_t av[kRun];
    const int gr = t.row_org + grow0 + i;
    const bool row_in = gr >= 0 && gr < t.height;
    const int bc = t.col_org + gcol0 + 4 * w0;
    const bool inside = row_in && bc >= 0 && bc + 4 * kRun <= t.width;
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      const uint32_t s = sv[q];
      uint32_t dm = 0;
      uint32_t A = s;
      if constexpr (kMulti) {
        dm = dying(s);
        A = s & ~dm & 0x01010101u;
      }
      uint32_t nb;
      if constexpr (kR1) {
        // the box sums of the four lanes at once (at most 9 a lane, so no
        // lane carries: every alive byte read is 0 or 1), then bit idx_b of
        // the set for each lane, put at bit 8b by a funnel shift of the set
        // shifted left by 8b
        const uint32_t box = v[q + 1] + __funnelshift_l(v[q], v[q + 1], 8) +
                             __funnelshift_r(v[q + 1], v[q + 2], 8);
        const uint32_t idx = box + A * rs.kmul;
        uint32_t x[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) x[b] = __funnelshift_r(rs.tlo[b], rs.thi[b], idx >> (8 * b));
        nb = ((x[0] & 0x000000FFu) | (x[1] & 0x0000FF00u) | (x[2] & 0x00FF0000u) |
              (x[3] & 0xFF000000u)) &
             0x01010101u;
      } else {
        const uint32_t e_hi = ev[q + 1];
        const uint32_t l_hi = lv[q + 1];
        const uint32_t E = __funnelshift_r(e_lo, e_hi, 8 * el);
        const uint32_t L = __funnelshift_r(l_lo, l_hi, 8 * ll);
        e_lo = e_hi;
        l_lo = l_hi;
        // lane b's box sum: S + the entering minus the leaving sums of lanes
        // 0 .. b; its index in the set adds K for an alive cell; an index
        // past the set (a cell no needed cell reads) reads its last word
        uint32_t x[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t lanes = 0xFFFFFFFFu >> (8 * (3 - b));
          const uint32_t tb = __dp4a(E, lanes & 0x01010101u, dp4a_us(L, lanes, S));
          const uint32_t idx = tb + __byte_perm(A, 0, 0x4440 + b) * rs.kmul;
          x[b] = rs.table[min(idx >> 5, rs.last)] >> (idx & 31u);
          if (b == 3) S = tb;
        }
        nb = __byte_perm(__byte_perm(x[0], x[1], 0x0040), __byte_perm(x[2], x[3], 0x0040),
                         0x5410) &
             0x01010101u;
      }
      const uint32_t m = inside ? 0xFFFFFFFFu : row_in ? word_mask(bc + 4 * q, t.width) : 0u;
      if constexpr (kMulti) {
        // states 0 and 1: the bit, or 2 where an alive cell does not survive;
        // states s >= 2: (s + 1) % C
        const uint32_t live = nb + 2u * (A & ~nb);
        const uint32_t dead = (s + 0x01010101u) & ~top_bits(s + wrap);  // s + 1 == C: 0
        ov[q] = ((live & ~dm) | (dead & dm)) & m;
        av[q] = nb & ~dm & m;
      } else {
        ov[q] = nb & m;
      }
    }
    *reinterpret_cast<uint4*>(out + i * t.pitch + 4 * w0) = make_uint4(ov[0], ov[1], ov[2], ov[3]);
    if constexpr (kMulti) {
      *reinterpret_cast<uint4*>(al + i * t.pitch + 4 * w0) = make_uint4(av[0], av[1], av[2], av[3]);
    }
  });
}

// Output rows [0, tile rows) and columns [0, tile_cols) of the tile from
// window row h + i, column margin + c, N bytes a store
template <int N>
__device__ __forceinline__ void store_chunks(const Tiling& t, const uint8_t* st, int h, int row0,
                                             int col0) {
  for_each_item(t.tile_rows, t.tile_cols / N, [&](int i, int j) {
    const int gr = row0 + i;
    const int gc = col0 + j * N;
    if (gr >= t.out_rows || gc >= t.out_cols) return;
    const uint8_t* s = st + (h + i) * t.pitch + t.margin + j * N;
    int8_t* g = t.dst + static_cast<ptrdiff_t>(gr) * t.out_cols + gc;
    if constexpr (N == 16) {
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    } else if constexpr (N == 8) {
      *reinterpret_cast<uint2*>(g) = *reinterpret_cast<const uint2*>(s);
    } else if constexpr (N == 4) {
      *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(s);
    } else {
      *g = static_cast<int8_t>(*s);
    }
  });
}

// k substeps of one output tile: the window from `src`, the tile back to
// t.dst.
template <class Src>
__device__ __forceinline__ void int8_tile(const Src& src, const RuleArgs& rule, const Tiling& t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = rule.radius;
  const int k = rule.k;
  const int h = r * k;
  const int ext_r = t.tile_rows + 2 * h;
  const bool multi = rule.states > 2;
  const bool r1 = r == 1;  // the set fits one word: 2 * (max_count + 1) <= 20 bits
  const int tbytes = r1 ? 0 : (4 * rule.nwords + 15) & ~15;
  const int plane = ext_r * t.pitch;
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  // r >= 2: the states, the alive bits (C > 2) and the vertical sums between
  // two guards.  r = 1: the states (C > 2) and two planes of alive bits
  // that the substeps alternate, each with a 16-byte guard before and
  // after; at C = 2 the states are the alive bits.
  uint8_t* st = smem + tbytes;                        // states
  uint8_t* al = multi ? st + plane : st;              // alive bits
  uint8_t* vs = al + plane + kGuard;                  // vertical sums (r >= 2)
  uint8_t* nx = nullptr;                              // r = 1: the other alive plane
  if (r1) {
    al = (multi ? st + plane : st) + 16;
    nx = al + plane + 16;
    if (!multi) st = al;
    // every alive byte a pass reads must be 0 or 1, the guards' and the
    // pads' too, else a lane of the sums could carry into the next
    for (int i = threadIdx.x; i < (2 * plane + 48) / 16; i += kThreads) {
      reinterpret_cast<uint4*>(al - 16)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  }
  const int wp = t.pitch / 4;                         // words a row of st and al
  const int vwp = t.vpitch / 4;

  const int row0 = static_cast<int>(blockIdx.y) * t.tile_rows;  // first output row
  const int col0 = static_cast<int>(blockIdx.x) * t.tile_cols;  // first output column
  const int grow0 = row0 - h;         // output row of window row 0
  const int gcol0 = col0 - t.margin;  // output column of window column 0

  Sets rs{};
  rs.kmul = static_cast<uint32_t>(rule.max_count + (rule.center ? 1 : 0));
  if (r1) {
    const uint32_t bits = __ldg(rule.bits);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      rs.tlo[b] = bits << (8 * b);
      rs.thi[b] = b == 0 ? 0u : bits >> (32 - 8 * b);
    }
  } else {
    for (int i = threadIdx.x; i < rule.nwords; i += kThreads) table[i] = __ldg(rule.bits + i);
    rs.table = table;
    rs.last = static_cast<uint32_t>(rule.nwords - 1);
  }

  // -- the window, then its alive bits ----------------------------------------
  src.load(st, t.pitch, grow0, gcol0, ext_r, t.ext_c);
  cp_async_wait_all();
  __syncthreads();
  if (multi) {
    for_each_item(ext_r, t.ext_c / 4, [&](int i, int w) {
      const uint32_t s = reinterpret_cast<const uint32_t*>(st)[i * wp + w];
      reinterpret_cast<uint32_t*>(al)[i * wp + w] = s & ~dying(s) & 0x01010101u;
    });
    __syncthreads();
  }

  for (int s = 1; s <= k; ++s) {
    // the rows and columns the tile needs after substeps s + 1 .. k
    const int lo_r = s * r;
    const int hi_r = ext_r - s * r;
    const int need_lo = t.margin - (k - s) * r;
    const int need_hi = t.margin + t.tile_cols + (k - s) * r;

    const int hw0 = (need_lo >> 4) << 2;
    const int hw1 = ((need_hi + 15) >> 4) << 2;
    if (r1) {
      // one pass: the vertical sums from three rows of alive bits, read
      // from one plane while the other takes the new ones
      if (multi) {
        horizontal<true, true>(rs, rule, t, st, st, nx, al, lo_r, hi_r, hw0, hw1, grow0, gcol0);
      } else {
        horizontal<true, false>(rs, rule, t, al, nx, nullptr, al, lo_r, hi_r, hw0, hw1, grow0,
                                gcol0);
      }
      uint8_t* tmp = al;
      al = nx;
      nx = tmp;
      if (!multi) st = al;
      __syncthreads();
      continue;
    }

    // -- 1. vertical running sums over the columns those cells read --------
    {
      const int vw0 = (need_lo - r) >> 2;
      const int nvw = ((need_hi + r + 3) >> 2) - vw0;
      const int nrows = hi_r - lo_r;
      const int nseg = max(1, kThreads / nvw);
      const int seg = (nrows + nseg - 1) / nseg;
      const uint32_t* a = reinterpret_cast<const uint32_t*>(al) + vw0;
      uint32_t* v = reinterpret_cast<uint32_t*>(vs) + vw0;
      for_each_item(nseg, nvw, [&](int g, int j) {
        const int i0 = lo_r + g * seg;
        const int i1 = min(i0 + seg, hi_r);
        if (i0 >= i1) return;
        uint32_t acc = 0;
        for (int i = i0 - r; i < i0 + r; ++i) acc += a[i * wp + j];
        for (int i = i0; i < i1; ++i) {
          acc += a[(i + r) * wp + j];
          v[i * vwp + j] = acc;
          acc -= a[(i - r) * wp + j];
        }
      });
    }
    __syncthreads();

    // -- 2. box sums, the rule and the board mask, in place ----------------
    if (multi) {
      horizontal<false, true>(rs, rule, t, st, st, al, vs, lo_r, hi_r, hw0, hw1, grow0, gcol0);
    } else {
      horizontal<false, false>(rs, rule, t, st, st, al, vs, lo_r, hi_r, hw0, hw1, grow0, gcol0);
    }
    __syncthreads();
  }

  // -- the tile back to the output ----------------------------------------------
  switch (t.io) {
    case 16:
      store_chunks<16>(t, st, h, row0, col0);
      break;
    case 8:
      store_chunks<8>(t, st, h, row0, col0);
      break;
    case 4:
      store_chunks<4>(t, st, h, row0, col0);
      break;
    default:
      store_chunks<1>(t, st, h, row0, col0);
  }
}

__global__ void __launch_bounds__(kThreads)
int8_tiled_kernel(BoardSrc src, RuleArgs rule, Tiling t) {
  int8_tile(src, rule, t);
}

__global__ void __launch_bounds__(kThreads)
sharded_int8_kernel(ShardSrc src, RuleArgs rule, Tiling t) {
  int8_tile(src, rule, t);
}

// Launch `kernel` over the tiles of t.out_rows x t.out_cols output cells
// with `smem` bytes of dynamic shared memory; returns cudaGetLastError() (or
// the error of setting the shared-memory size).
template <typename Kernel, typename Src>
int launch(Kernel kernel, const Src& src, const RuleArgs& rule, const Tiling& t, int smem,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t.out_cols + t.tile_cols - 1) / t.tile_cols,
                  (t.out_rows + t.tile_rows - 1) / t.tile_rows);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(src, rule, t);
  return static_cast<int>(cudaGetLastError());
}

bool valid_io(int io) { return io == 1 || io == 4 || io == 8 || io == 16; }

}  // namespace

extern "C" {

// Kernel K2: k masked steps from src into dst (distinct contiguous
// int8[height, width] buffers on the current device), on `stream`.  The
// rule: bits (uint32[nwords] on the device, see RuleArgs), radius, states,
// center and max_count.  The layout (see Tiling): tiles of tile_rows x
// tile_cols cells, margin, ext_c, pitch and vpitch, and smem bytes of
// dynamic shared memory (kernels/int8_tiled.py: window, shared_bytes); io,
// the bytes of a copy or store (16, 8, 4 or 1), divides width and both
// buffers' addresses.  Returns cudaGetLastError() (or the error of setting
// the shared-memory size), or cudaErrorInvalidValue for arguments outside
// these.
int int8_tiled_multi_step(const void* src, void* dst, const void* bits, int nwords, int height,
                          int width, int radius, int k, int include_center, int states,
                          int max_count, int tile_rows, int tile_cols, int margin, int ext_c,
                          int pitch, int vpitch, int smem, int io, void* stream) {
  if (height < 1 || width < 1 || k < 1 || radius < 1 || radius > 127 || nwords < 1 ||
      !valid_io(io) || tile_cols % 16 != 0 || margin % 16 != 0 || pitch % 16 != 0 ||
      vpitch % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BoardSrc s{static_cast<const int8_t*>(src), height, width, io};
  const RuleArgs rule{static_cast<const uint32_t*>(bits), nwords, radius, k, states,
                      include_center, max_count};
  const Tiling t{tile_rows, tile_cols, margin, ext_c, pitch, vpitch, static_cast<int8_t*>(dst),
                 height, width, io, 0, 0, height, width};
  return launch(int8_tiled_kernel, s, rule, t, smem, stream);
}

// Kernel K4: k masked steps of one shard, from chunk (int8[rows, cols]) and
// its halos top and bot (int8[fr, cols] each, fr = radius * k) and, where
// fc > 0, left and right (int8[fr + rows + fr, fc] each, fc = radius * k;
// null where fc = 0) into dst (int8[rows, cols], none of the inputs), on
// `stream`.  (row0, col0) is the board coordinate of top[0][0]'s row and
// of left's column 0 (of the chunk's column 0 where fc = 0), and the board
// is height x width.  The rule and the layout as for K2; io divides cols
// and the addresses of top, chunk, bot and dst, io_side divides fc and cols
// and the addresses of left and right.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these.
int sharded_int8_block(const void* top, const void* chunk, const void* bot, const void* left,
                       const void* right, void* dst, const void* bits, int nwords, int rows,
                       int cols, int fr, int fc, int row0, int col0, int height, int width,
                       int radius, int k, int include_center, int states, int max_count,
                       int tile_rows, int tile_cols, int margin, int ext_c, int pitch,
                       int vpitch, int smem, int io, int io_side, void* stream) {
  if (rows < 1 || cols < 1 || k < 1 || radius < 1 || radius > 127 || nwords < 1 ||
      fr != radius * k || (fc != 0 && fc != fr) ||
      ((left == nullptr || right == nullptr) != (fc == 0)) || !valid_io(io) ||
      !valid_io(io_side) || tile_cols % 16 != 0 || margin % 16 != 0 || pitch % 16 != 0 ||
      vpitch % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ShardSrc s{static_cast<const int8_t*>(top), static_cast<const int8_t*>(chunk),
                   static_cast<const int8_t*>(bot), static_cast<const int8_t*>(left),
                   static_cast<const int8_t*>(right), rows, cols, fr, fc, io, io_side};
  const RuleArgs rule{static_cast<const uint32_t*>(bits), nwords, radius, k, states,
                      include_center, max_count};
  const Tiling t{tile_rows, tile_cols, margin, ext_c, pitch, vpitch, static_cast<int8_t*>(dst),
                 rows, cols, io, row0 + fr, col0 + fc, height, width};
  return launch(sharded_int8_kernel, s, rule, t, smem, stream);
}

// Blocks of K2 (kernel 0) or K4 (kernel 1) that one SM holds at smem bytes
// of dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or the negated CUDA error.
int int8_tiled_blocks_per_sm(int kernel, int smem) {
  const void* fn = kernel == 0 ? reinterpret_cast<const void*>(int8_tiled_kernel)
                               : reinterpret_cast<const void*>(sharded_int8_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // extern "C"
