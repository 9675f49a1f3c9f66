// Threefry-2x32/20 kernels of the stochastic tier for Hopper (sm_90a):
// kernels K6 and K7.
//
// Neither replaces a Pallas kernel: the JAX package runs this tier as
// jax.jit over lax.scan (tpu_life/mc/engine.py: MCPackedDeviceRunner over
// mc/packed.py::make_sweep, MCDeviceRunner over mc/ising.py::sweep), and
// XLA fuses each half-sweep's hash into one pass.  PyTorch has no call that
// computes this hash keyed by a cell's coordinates, and plain ops take some
// 112 launches an evaluation, each writing a tensor of the whole board; so
// the hash lives here, in two kernels, each computing a function of the JAX
// package to the same bits.
//
// The generator (tpu_life_torch/mc/prng.py): the draw of cell index idx
// (64-bit, origin + r*w + c) at counter word c1 = step*NSUB + substream is
// word 0 of threefry2x32(key, (lo(idx), c1)), where key is the run's
// (k0, k1) for idx < 2^32 and, for the 2^32-cell block hi = idx >> 32 > 0,
// threefry2x32((k0, k1), (hi, 0xFFFFFFFF)) (derive_wide_keys).
//
// K7, cell_uniforms_kernel: word 0 (or 1) of that hash for every cell of an
// [h, w] block at (k0, k1, c1, origin), one thread a cell: prng.cell_uniforms
// (word 0) and the word-1 draw of seeded staging.  Its plain version is
// prng.cell_uniforms_torch.  Bound on an H100: word 0 of a draw needs 66
// 32-bit integer operations a cell.  Of the 20 rounds' rotates and xors,
// round 1's rotate acts on x1 = c1 + k1, the same for every cell, and
// round 20's rotate and xor feed only word 1: 18 rotates (SHF) and 19
// xors (LOP3), which issue only on the integer pipe, 64 a clock an SM.
// The 29 adds (20 rounds, the counter's key folded into round 1's, 5 key
// injections into x0 and the 4 into x1 that word 0 reads) may also issue
// as IMAD on the multiply-add pipe.  So 37 / 64 of a clock a draw, 0.59 ms
// for the 268,435,456 draws of a 16384^2 board; writing them (1 GiB)
// takes 0.32 ms, so operations bound it.
//
// K6, packed_metropolis_half_kernel: one checkerboard half-sweep of
// mc/packed.py::make_sweep on the packed spins (uint32[h, wp] words, spin
// (r, c) at bit c % 32 of word c / 32, wp = ceil(w / 32)), from x into y.
// One thread a word: it reads its word and the four torus neighbour words
// (rows mod h; the column seam at the logical width w, not at 32 * wp),
// reduces the four neighbour planes by carry-save adders to the bit planes
// of the count, and forms the planes needs3 and needs4 (the cells whose
// table index (s * nsum + 4) >> 1 is 3 or 4).  The odd half reads the even
// half's result, so a sweep is two launches.  Its plain version is
// mc/packed.py::half_sweep_torch.
//
// Bound on an H100: the function needs the draw of an active cell only
// where the table decides its move (dE > 0: needs3 | needs4, 5/16 of a
// random board's active cells, most of a lattice ordering near T_c; every
// other active cell force-accepts), 39 integer-pipe operations each (word
// 0's 37, the select of the table entry and one unsigned compare), and
// some 18 logic operations a word; the words read and written weigh less,
// so operations bound it.  The design does that work and little else:
// - Only the decided cells are hashed, spread evenly over the warp.  A
//   lane forms its word's masks d3 = needs3 & active and d4 = needs4 &
//   active (active: the parity's columns a + 2t, a = (r + parity) & 1, and
//   c < w; the plain version pads the row with draws the column mask never
//   consumes); the warp takes exclusive prefix sums of popc(d3) and
//   popc(d4) in one shuffle scan (a half-word each), and each lane appends
//   one 16-bit entry (owner lane, bit) a set bit to the warp's list in
//   shared memory, by predicated stores: the cells held against the
//   table's entry 3 first, then those held against entry 4.  Lane l then
//   hashes entries l, l + 32, ...: ceil(total / 32) draws a lane, where
//   hashing cell by cell in its owner's lane would cost the warp its
//   busiest lane's count, close to 16 on any board.  The cell's index
//   comes from its owner's word (a warp spans rows where wp is not a
//   multiple of 32).
// - One compare a decided cell: needs3 and needs4 are disjoint, and the
//   part of the list an entry lies in names its table entry, so each of
//   the two loops over the list compares against one threshold.  An accept
//   sets the owner's bit in the warp's result word (atomicOr in shared
//   memory), and the owner writes x ^ ((active & ~d) | accepted): the
//   undecided active cells force-accept.
// - Two instances.  The narrow one (Wide = false) serves a launch whose
//   cells all lie in the first 2^32-cell block of draws (origin + h * w <=
//   2^32: every board up to 65536^2 at origin 0): the key is the run's,
//   the index a 32-bit lo, round 1 hoisted (x1 = c1 + k1 is the same for
//   every cell, so x0 = lo + (k0 + c1 + k1) and x1 = rotl(c1 + k1, 13) ^ x0
//   are one add and one xor of a uniform) and each key injection folded
//   into a constant of the launch (NarrowHash, built on the host); its
//   adds issue on the multiply-add pipe, beside the rotates and xors on
//   the integer pipe.  The wide one (Wide = true) takes any origin: a
//   64-bit index and the key of the index's 2^32-cell block (block_key)
//   checked draw by draw, since a warp's entries may lie on either side of
//   a block's end.
// Lanes past the board's end take part in every shuffle with d = 0, so a
// warp never leaves a _sync call short of lanes.
//
// The batch modes serve the stochastic serving tier (the JAX package's
// MCPackedVmapEngine and MCVmapEngine, tpu_life/mc/engine.py: a lax.scan
// over a vmapped sweep whose freeze mask holds a slot once its budget is
// spent, and whose per-slot step counter advances only while the slot is
// live).  Each takes S boards of one shape, the slot on the grid's y axis,
// and reads each slot's key halves k0 and k1, absolute sweep counter,
// acceptance table (uint32[5]) and remaining budget from device arrays of
// length S (BatchSlots), so a chunk needs nothing from the host; a launch
// is one sweep of the chunk, at `offset` sweeps into it.  A slot whose
// budget is at most offset is frozen; a live one draws at counter word
// (counter + offset) * NSUB + substream.
//
// K6's batch mode, packed_metropolis_batch_kernel: K6's half-sweep of each
// live slot (the decided cells only, spread over the warp through a list in
// shared memory; the narrow and wide instances), a frozen slot's words
// copied through, so the two buffers a chunk ping-pongs between never go
// stale.  Its bound is K6's; its design pays less than K6's body beside
// the hash (the kernel's own note below): a thread takes four words of a
// row, the list is built in work proportional to the decided cells, and
// each thread forms its slot's uniforms from the slot's state, with no
// barrier.
//
// K7's batch mode, cell_uniforms_batch_kernel: word 0 of the hash for
// every cell of each slot's [h, w] board (the narrow schedule: the roll
// path's boards have at most 2^32 cells), eight consecutive draws a thread
// from the slot's narrow hash, stored 16 bytes at a time; a frozen slot's
// draws are zeros, which its consumer masks.  It draws the roll path's
// half-sweeps and the noisy flips.  Bound: K7's, 37 integer-pipe
// operations a draw.
//
// All four launch on the caller's stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments outside what
// they take).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kWideKeyTag = 0xFFFFFFFFu;
constexpr int kThreads = 256;
// prng.NSUB, and the substreams of the half-sweeps' parities
constexpr uint32_t kNsub = 4;
constexpr uint32_t kSubEven = 0, kSubOdd = 1;
constexpr int kMaxSlots = 65535;  // the grid's y extent

// the rotation of round i (0..3) of group g (0..4)
__device__ __forceinline__ int rotation(int g, int i) {
  return (g & 1) ? (i == 0 ? 17 : i == 1 ? 29 : i == 2 ? 16 : 24)
                 : (i == 0 ? 13 : i == 1 ? 15 : i == 2 ? 26 : 6);
}

// Threefry-2x32, 20 rounds: counter (c0, c1) under key (k0, k1)
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                              uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(g, i));
      x1 ^= x0;
    }
    const int a = (g + 1) % 3;
    const int b = (g + 2) % 3;
    x0 += a == 0 ? k0 : a == 1 ? k1 : k2;
    x1 += (b == 0 ? k0 : b == 1 ? k1 : k2) + static_cast<uint32_t>(g + 1);
  }
  return make_uint2(x0, x1);
}

// the key of the 2^32-cell block hi (derive_wide_keys): the run's key for
// block 0, a derived one past it
__device__ __forceinline__ uint2 block_key(uint32_t k0, uint32_t k1, uint32_t hi) {
  return hi == 0 ? make_uint2(k0, k1) : threefry2x32(k0, k1, hi, kWideKeyTag);
}

__global__ void __launch_bounds__(kThreads)
    cell_uniforms_kernel(uint32_t* __restrict__ out, long long n, uint32_t k0, uint32_t k1,
                         uint32_t c1, unsigned long long origin, int word) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long idx = origin + static_cast<unsigned long long>(i);
  const uint2 key = block_key(k0, k1, static_cast<uint32_t>(idx >> 32));
  const uint2 u = threefry2x32(key.x, key.y, static_cast<uint32_t>(idx), c1);
  out[i] = word ? u.y : u.x;
}

// The uniforms of one K6 launch, or of one slot of its batch mode: the
// run's key, the counter word and the acceptance table's entries 3 and 4.
struct Draws {
  uint32_t k0, k1, c1;
  uint32_t thr3, thr4;
};

// The per-slot state of a batch: device arrays of length S (thr: S rows
// of the uint32[5] table), which the serving engines keep.
struct BatchSlots {
  const uint32_t* k0;
  const uint32_t* k1;
  const uint32_t* counter;  // the absolute sweep counter of the chunk's start
  const uint32_t* thr;
  const int* rem;           // the budget left at the chunk's start
};

// slot s's counter word at `offset` sweeps into the chunk
__device__ __forceinline__ uint32_t slot_counter_word(const BatchSlots& slots, int s, int offset,
                                                      uint32_t substream) {
  return (slots.counter[s] + static_cast<uint32_t>(offset)) * kNsub + substream;
}

// Word 0 of threefry2x32((k0, k1), (lo, c1)) with every term that does not
// depend on lo folded into a constant of the launch: round 1's add and
// rotate, and the key injections with their round constants.
struct NarrowHash {
  uint32_t x0;       // k0 + (c1 + k1): x0 after round 1's add is lo + x0
  uint32_t x1;       // rotl(c1 + k1, 13): x1 after round 1 is x1 ^ x0
  uint32_t inj0[5];  // the key injected into x0 after group g
  uint32_t inj1[4];  // ... into x1, with g + 1 (group 4's feeds only word 1)
  // 1, which the hash's adds multiply by so that they issue as IMAD on the
  // multiply-add pipe: left with plain adds, the compiler fuses pairs of
  // them into IADD3 on the integer pipe, which the rotates and xors fill
  uint32_t one;
};

__host__ __device__ NarrowHash narrow_hash(uint32_t k0, uint32_t k1, uint32_t c1) {
  const uint32_t keys[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const uint32_t x1 = c1 + k1;
  NarrowHash n{};
  n.x0 = k0 + x1;
  n.one = 1;
  n.x1 = (x1 << 13) | (x1 >> 19);
  for (int g = 0; g < 5; ++g) {
    n.inj0[g] = keys[(g + 1) % 3];
    if (g < 4) n.inj1[g] = keys[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return n;
}

// word 0 of threefry2x32 at counter (lo, c1) under the run's key, from the
// launch's NarrowHash: 19 rounds after the hoisted round 1
__device__ __forceinline__ uint32_t threefry2x32_word0_narrow(const NarrowHash& n,
                                                             uint32_t lo) {
  const auto add = [&n](uint32_t a, uint32_t b) { return b * n.one + a; };  // IMAD
  uint32_t x0 = add(lo, n.x0);
  uint32_t x1 = n.x1 ^ x0;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = g == 0 ? 1 : 0; i < 4; ++i) {
      x0 = add(x0, x1);
      x1 = __funnelshift_l(x1, x1, rotation(g, i));
      x1 ^= x0;
    }
    x0 = add(x0, n.inj0[g]);
    if (g < 4) x1 = add(x1, n.inj1[g]);
  }
  return x0;
}

constexpr int kWarps = kThreads / 32;
constexpr int kEntries = 32 * 16;  // a warp's most decided cells

// Appends entry v to a warp's list at the shared address `at` where `take`
// is not 0, and advances `at` past it: a predicated store and add, no
// branch.
__device__ __forceinline__ void append_if(uint32_t take, uint32_t& at, uint32_t v) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t@p st.shared.u16 [%0], %2;\n\t"
      "@p add.u32 %0, %0, 2;\n\t}"
      : "+r"(at)
      : "r"(take), "h"(static_cast<unsigned short>(v))
      : "memory");
}

// The draw of the cell at index idx: the narrow instance's hash of a
// 32-bit index, or the wide one's under the key of the index's 2^32-cell
// block (key_hi, key: the last block's, kept across draws).
template <bool Wide, typename Index>
__device__ __forceinline__ uint32_t cell_draw(const Draws& draws, const NarrowHash& narrow,
                                              Index idx, uint32_t& key_hi, uint2& key) {
  if constexpr (Wide) {
    const uint32_t hi = static_cast<uint32_t>(idx >> 32);
    if (hi != key_hi) {
      key = block_key(draws.k0, draws.k1, hi);
      key_hi = hi;
    }
    return threefry2x32(key.x, key.y, static_cast<uint32_t>(idx), draws.c1).x;
  } else {
    return threefry2x32_word0_narrow(narrow, idx);
  }
}

// One half-sweep of parity `parity` of the board x into y by the calling
// block's kThreads words (blockIdx.x): K6's body.
template <bool Wide>
__device__ __forceinline__ void half_sweep_words(const uint32_t* __restrict__ x,
                                                 uint32_t* __restrict__ y, int h, int w, int wp,
                                                 int parity, unsigned long long origin,
                                                 const Draws& draws, const NarrowHash& narrow) {
  // a 32-bit word and cell index where the launch's cells lie below 2^32
  using Index = typename std::conditional<Wide, unsigned long long, uint32_t>::type;
  // each warp's list of entries owner << 7 | bit: first the cells held
  // against the table's entry 3, then those held against entry 4
  __shared__ uint16_t entries[kWarps][kEntries];
  __shared__ Index first_cell[kWarps][32];  // the index of each lane's bit 0
  __shared__ uint32_t accepted[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Index n = static_cast<Index>(h) * static_cast<Index>(wp);
  const Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t c = 0, active = 0, d3 = 0, d4 = 0;
  int a = 0;  // the active parity's bits are a + 2t
  if (i < n) {
    const Index r = i / static_cast<Index>(wp);
    const int j = static_cast<int>(i - r * static_cast<Index>(wp));
    const uint32_t* row = x + r * static_cast<Index>(wp);
    c = row[j];
    const uint32_t up = x[(r + 1 == static_cast<Index>(h) ? 0 : r + 1) * wp + j];
    const uint32_t down = x[(r == 0 ? static_cast<Index>(h) - 1 : r - 1) * wp + j];
    const int rem = w & 31;
    const int top = (rem ? rem : 32) - 1;  // bit of column w-1 in the last word
    // L[c] = x[(c-1) mod w], R[c] = x[(c+1) mod w]
    const uint32_t carry_l = j > 0 ? row[j - 1] >> 31 : (row[wp - 1] >> top) & 1u;
    const uint32_t left = (c << 1) | carry_l;
    const uint32_t right =
        j < wp - 1 ? (c >> 1) | (row[j + 1] << 31) : (c >> 1) | ((row[0] & 1u) << top);
    // carry-save reduction of the four neighbour planes to the count's planes
    const uint32_t s1 = up ^ down ^ left;
    const uint32_t cs1 = (up & down) | ((up ^ down) & left);
    const uint32_t b0 = s1 ^ right;
    const uint32_t cs2 = s1 & right;
    const uint32_t b1 = cs1 ^ cs2;
    const uint32_t b2 = cs1 & cs2;
    const uint32_t n3 = b0 & b1 & ~b2;
    const uint32_t n1 = b0 & ~b1 & ~b2;
    const uint32_t n0 = ~(b0 | b1 | b2);
    const int cols = min(32, w - 32 * j);  // valid columns in this word
    a = static_cast<int>((r + parity) & 1);
    active = (a ? 0xAAAAAAAAu : 0x55555555u) & (cols == 32 ? 0xFFFFFFFFu : (1u << cols) - 1u);
    // needs3 and needs4, the cells the table's entries 3 and 4 decide (disjoint)
    d3 = ((c & n3) | (~c & n1)) & active;
    d4 = ((c & b2) | (~c & n0)) & active;
    first_cell[warp][lane] = static_cast<Index>(origin) + r * static_cast<Index>(w) +
                             32 * static_cast<Index>(j);
  }
  accepted[warp][lane] = 0;
  // the warp's exclusive prefix sums of its lanes' decided cells, entry 3's
  // in the low half-word and entry 4's in the high one
  const int count = __popc(d3) | __popc(d4) << 16;
  int below = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, below, o);
    if (lane >= o) below += v;
  }
  const int sums = __shfl_sync(0xFFFFFFFFu, below, 31);
  below -= count;
  const int total3 = sums & 0xFFFF;
  const int total = total3 + (sums >> 16);
  // one entry a decided cell, in the lane's slices of the two parts
  const uint32_t list = static_cast<uint32_t>(__cvta_generic_to_shared(entries[warp]));
  uint32_t at3 = list + 2 * (below & 0xFFFF);
  uint32_t at4 = list + 2 * (total3 + (below >> 16));
  const uint32_t even3 = d3 >> a, even4 = d4 >> a;
  const uint32_t tag = static_cast<uint32_t>(lane) << 7 | static_cast<uint32_t>(a);
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    append_if(even3 & 1u << 2 * t, at3, tag + 2 * t);
    append_if(even4 & 1u << 2 * t, at4, tag + 2 * t);
  }
  __syncwarp();
  // lane l hashes entries l, l + 32, ...: one compare each, against the
  // threshold of the part of the list the entry lies in
  [[maybe_unused]] uint32_t key_hi = 0;
  [[maybe_unused]] uint2 key = make_uint2(draws.k0, draws.k1);
  const uint16_t* got = entries[warp];
  int e = lane;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const uint32_t thr = part ? draws.thr4 : draws.thr3;
    for (const int end = part ? total : total3; e < end; e += 32) {
      const uint32_t entry = got[e];
      const uint32_t bit = entry & 31u;
      const Index idx = first_cell[warp][entry >> 7] + bit;
      if (cell_draw<Wide>(draws, narrow, idx, key_hi, key) < thr) {
        atomicOr(&accepted[warp][entry >> 7], 1u << bit);
      }
    }
  }
  __syncwarp();
  // the undecided active cells force-accept
  if (i < n) y[i] = c ^ ((active & ~(d3 | d4)) | accepted[warp][lane]);
}

template <bool Wide>
__global__ void __launch_bounds__(kThreads)
    packed_metropolis_half_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                  int h, int w, int wp, int parity, unsigned long long origin,
                                  Draws draws, NarrowHash narrow) {
  half_sweep_words<Wide>(x, y, h, w, wp, parity, origin, draws, narrow);
}

// -- the batch modes ------------------------------------------------------------

// The uniforms of slot s at `offset` sweeps into the chunk, formed by each
// thread from the slot's state (loads of one address a warp, some ten
// integer operations): no block builds them in shared memory, and no
// barrier waits on one thread.  `one` is the launch's constant 1
// (NarrowHash::one), a parameter so that the hash's adds stay IMAD.
struct SlotDraws {
  Draws draws;
  NarrowHash narrow;
};

__device__ __forceinline__ SlotDraws slot_draws(const BatchSlots& slots, int s, int offset,
                                                uint32_t substream, uint32_t one) {
  const uint32_t k0 = slots.k0[s], k1 = slots.k1[s];
  const uint32_t c1 = slot_counter_word(slots, s, offset, substream);
  SlotDraws d{Draws{k0, k1, c1, 0u, 0u}, narrow_hash(k0, k1, c1)};
  d.narrow.one = one;
  return d;
}

// The batch modes' blocks: 128 threads (1-4% faster than 256 on an H100).
constexpr int kBatchThreads = 128;
constexpr int kBatchWarps = kBatchThreads / 32;
// K6's batch mode takes a group of kGroup consecutive words of one row a
// thread: the row's last group may hold fewer, and no group spans rows.
constexpr int kGroup = 4;
constexpr int kPairs = kGroup / 2;
constexpr int kGroupEntries = 32 * kGroup * 16;  // a warp's most decided cells

// the position of the highest set bit of v (v != 0): one FLO
__device__ __forceinline__ uint32_t top_bit(uint32_t v) {
  uint32_t p;
  asm("bfind.u32 %0, %1;" : "=r"(p) : "r"(v));
  return p;
}

// Appends tag + p for each set bit p of y, the highest first, to a warp's
// list at `at`: work in proportion to the set bits.
__device__ __forceinline__ void append_bits(uint32_t y, uint32_t tag, uint16_t*& at) {
  while (y) {
    const uint32_t p = top_bit(y);
    y ^= 1u << p;
    *at++ = static_cast<uint16_t>(tag + p);
  }
}

// Sets `bit` of the shared word at `word` where draw < thr: a predicated
// reduction, with no branch around it
__device__ __forceinline__ void or_if_below(uint32_t draw, uint32_t thr, uint32_t* word,
                                            uint32_t bit) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.lo.u32 p, %0, %1;\n\t@p red.shared.or.b32 [%2], %3;\n\t}"
      :
      : "r"(draw), "r"(thr), "r"(static_cast<uint32_t>(__cvta_generic_to_shared(word))), "r"(bit)
      : "memory");
}

// A pair of words 2p, 2p + 1 of a group: the index of its first active
// cell (word 2p's column a) less 32 x the pair's place in the warp, and its
// accepted cells, interleaved as in the decided masks (below).
template <typename Index>
struct PairCells {
  Index base;
  uint32_t accepted;
};

// K6's batch mode: slot blockIdx.y's board of the batch x ([S, h, wp]
// words) into y, at `offset` sweeps into the chunk.  K6's function; the
// design differs from K6's body where a thread took one word:
// - A thread takes kGroup consecutive words of a row, so the division that
//   places it, the row addresses, the warp's scan and the slot's uniforms
//   are paid once a group; a word's horizontal neighbours come from its
//   group's registers (funnel shifts), only the group's two outer
//   neighbours are loaded.
// - A pair of words holds 32 active cells: the decided masks of words 2p
//   and 2p + 1 interleave into one 32-bit mask y = (d_2p >> a) | (d_2p+1 >>
//   a) << 1, word 2p's cells at the even bits.  The entry e = pair << 5 |
//   q names the cell base + e + 31 * (e & 1) of its pair's PairCells, and
//   bit q of its accepted cells.
// - The warp's list is built in work proportional to the decided cells:
//   each lane walks the set bits of its masks, y3 (held against the
//   table's entry 3) of each pair, then y4, the highest bit first, and
//   stores their entries at its slices of the two parts; entry 3's part
//   first, then entry 4's, so one compare an entry still suffices, and a
//   predicated shared-memory reduction records an accept.
// - The slot's uniforms come from each thread's own loads (SlotDraws).
template <bool Wide>
__global__ void __launch_bounds__(kBatchThreads)
    packed_metropolis_batch_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                   int h, int w, int wp, int parity, unsigned long long origin,
                                   BatchSlots slots, int offset, uint32_t one) {
  using Index = typename std::conditional<Wide, unsigned long long, uint32_t>::type;
  __shared__ uint16_t entries[kBatchWarps][kGroupEntries];
  __shared__ PairCells<Index> pairs[kBatchWarps][32 * kPairs];
  const int s = blockIdx.y;
  const size_t plane = static_cast<size_t>(h) * static_cast<size_t>(wp);
  x += s * plane;
  y += s * plane;
  // the slot's state is read before its budget decides, so that the loads overlap
  const bool frozen = slots.rem[s] <= offset;
  SlotDraws slot = slot_draws(slots, s, offset, parity ? kSubOdd : kSubEven, one);
  slot.draws.thr3 = slots.thr[5 * s + 3];
  slot.draws.thr4 = slots.thr[5 * s + 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Index per_row = static_cast<Index>((wp + kGroup - 1) / kGroup);  // groups a row
  const Index gi = static_cast<Index>(blockIdx.x) * kBatchThreads + threadIdx.x;
  const bool in = gi < static_cast<Index>(h) * per_row;
  const int rem = w & 31;
  const int top = (rem ? rem : 32) - 1;  // bit of column w-1 in the last word
  Index r = 0;
  int j0 = 0, nv = 0;  // the group's first word and its words
  uint32_t c[kGroup] = {}, up[kGroup] = {}, down[kGroup] = {};
  uint32_t before = 0, after = 0;
  if (in) {
    r = gi / per_row;
    j0 = static_cast<int>(gi - r * per_row) * kGroup;
    nv = min(kGroup, wp - j0);
    const uint32_t* row = x + r * static_cast<Index>(wp);
    const uint32_t* above = x + (r + 1 == static_cast<Index>(h) ? 0 : r + 1) * wp;
    const uint32_t* below = x + (r == 0 ? static_cast<Index>(h) - 1 : r - 1) * wp;
    // every load at once, none behind a branch: a word past the row's end
    // repeats its last word, which nothing reads
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int j = min(j0 + g, wp - 1);
      c[g] = row[j];
      up[g] = above[j];
      down[g] = below[j];
    }
    // bit 31 of `before`: the cell left of the group; `after`: the bits the
    // right neighbour of its last word takes (the next word's bit 0, or
    // column 0 across the seam at column w - 1)
    const uint32_t left_word = row[j0 > 0 ? j0 - 1 : wp - 1];
    before = j0 > 0 ? left_word : left_word << (31 - top);
    const uint32_t right_word = row[j0 + nv < wp ? j0 + nv : 0];
    after = j0 + nv < wp ? right_word << 31 : (right_word & 1u) << top;
  }
  if (frozen) {  // the same branch for the whole block
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < nv) y[r * static_cast<Index>(wp) + j0 + g] = c[g];
    }
    return;
  }
  const int a = static_cast<int>((r + parity) & 1);  // the active parity's bits are a + 2t
  const uint32_t parity_mask = a ? 0xAAAAAAAAu : 0x55555555u;
  const uint32_t last_mask = parity_mask & (rem ? (1u << rem) - 1u : 0xFFFFFFFFu);
  const int last = in ? wp - 1 - j0 : -1;  // the group's word that ends the row, if any
  uint32_t keep[kGroup];  // x ^ the undecided active cells (they force-accept)
  uint32_t d3[kGroup], d4[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const uint32_t left = __funnelshift_l(g ? c[g - 1] : before, c[g], 1);
    const uint32_t right = (c[g] >> 1) | (g + 1 < nv ? c[(g + 1) % kGroup] << 31 : after);
    const uint32_t s1 = up[g] ^ down[g] ^ left;
    const uint32_t cs1 = (up[g] & down[g]) | ((up[g] ^ down[g]) & left);
    const uint32_t b0 = s1 ^ right;
    const uint32_t cs2 = s1 & right;
    const uint32_t b1 = cs1 ^ cs2;
    const uint32_t b2 = cs1 & cs2;
    const uint32_t n3 = b0 & b1 & ~b2;
    const uint32_t n1 = b0 & ~b1 & ~b2;
    const uint32_t n0 = ~(b0 | b1 | b2);
    const uint32_t active = g < last ? parity_mask : g == last ? last_mask : 0u;
    d3[g] = ((c[g] & n3) | (~c[g] & n1)) & active;
    d4[g] = ((c[g] & b2) | (~c[g] & n0)) & active;
    keep[g] = c[g] ^ (active & ~(d3[g] | d4[g]));
  }
  uint32_t y3[kPairs], y4[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    y3[p] = (d3[2 * p] >> a) | (d3[2 * p + 1] >> a) << 1;
    y4[p] = (d4[2 * p] >> a) | (d4[2 * p + 1] >> a) << 1;
    // less 32 x the pair's place, so that an entry's cell is base + entry + 31 * (entry & 1)
    const int pair = lane * kPairs + p;
    pairs[warp][pair].base = static_cast<Index>(origin) + r * static_cast<Index>(w) +
                             32 * static_cast<Index>(j0 + 2 * p) + a - 32 * pair;
    pairs[warp][pair].accepted = 0;
  }
  // the warp's exclusive prefix sums of its lanes' decided cells, entry 3's
  // in the low half-word and entry 4's in the high one
  int count = 0;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) count += __popc(y3[p]) | __popc(y4[p]) << 16;
  int sum = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, sum, o);
    if (lane >= o) sum += v;
  }
  const int sums = __shfl_sync(0xFFFFFFFFu, sum, 31);
  sum -= count;
  const int total3 = sums & 0xFFFF;
  const int total = total3 + (sums >> 16);
  uint16_t* at3 = entries[warp] + (sum & 0xFFFF);
  uint16_t* at4 = entries[warp] + total3 + (sum >> 16);
#pragma unroll
  for (int p = 0; p < kPairs; ++p) append_bits(y3[p], (lane * kPairs + p) << 5, at3);
#pragma unroll
  for (int p = 0; p < kPairs; ++p) append_bits(y4[p], (lane * kPairs + p) << 5, at4);
  __syncwarp();
  // lane l hashes entries l, l + 32, ...: one compare each, against the
  // threshold of the part of the list the entry lies in
  [[maybe_unused]] uint32_t key_hi = 0;
  [[maybe_unused]] uint2 key = make_uint2(slot.draws.k0, slot.draws.k1);
  const uint16_t* e = entries[warp] + lane;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const uint32_t thr = part ? slot.draws.thr4 : slot.draws.thr3;
    for (const uint16_t* end = entries[warp] + (part ? total : total3); e < end; e += 32) {
      const uint32_t entry = *e;
      PairCells<Index>& cells = pairs[warp][entry >> 5];
      const Index idx = cells.base + entry + 31 * (entry & 1u);
      or_if_below(cell_draw<Wide>(slot.draws, slot.narrow, idx, key_hi, key), thr,
                  &cells.accepted, 1u << (entry & 31u));
    }
  }
  __syncwarp();
  if (in) {
    uint32_t* out = y + r * static_cast<Index>(wp) + j0;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const uint32_t acc = pairs[warp][lane * kPairs + g / 2].accepted >> (g & 1);
      if (g < nv) out[g] = keep[g] ^ ((acc & 0x55555555u) << a);
    }
  }
}

// K7's batch mode takes kDraws consecutive draws a thread, stored 16 bytes
// at a time where the slot's row of draws is 16-byte aligned.
constexpr int kDraws = 8;

// K7's batch mode: word 0 of the hash of each of the n cells of slot
// blockIdx.y's board into out ([S, n]), zeros for a frozen slot; the
// narrow schedule (n <= 2^32) from the slot's uniforms (SlotDraws).
__global__ void __launch_bounds__(kBatchThreads)
    cell_uniforms_batch_kernel(uint32_t* __restrict__ out, long long n, BatchSlots slots,
                               uint32_t substream, int offset, uint32_t one) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kBatchThreads + threadIdx.x) * kDraws;
  if (i0 >= n) return;
  const int s = blockIdx.y;
  const bool live = slots.rem[s] > offset;
  const NarrowHash narrow = slot_draws(slots, s, offset, substream, one).narrow;
  uint32_t u[kDraws] = {};
  if (live) {
#pragma unroll
    for (int d = 0; d < kDraws; ++d) {
      u[d] = threefry2x32_word0_narrow(narrow, static_cast<uint32_t>(i0) + d);
    }
  }
  uint32_t* dst = out + static_cast<long long>(s) * n + i0;
  if (n % 4 == 0 && i0 + kDraws <= n) {
#pragma unroll
    for (int d = 0; d < kDraws; d += 4) {
      *reinterpret_cast<uint4*>(dst + d) = make_uint4(u[d], u[d + 1], u[d + 2], u[d + 3]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < kDraws; ++d) {
      if (i0 + d < n) dst[d] = u[d];
    }
  }
}

unsigned int blocks_for(long long n, int threads = kThreads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

// Kernel K7: word `word` (0 or 1) of the hash of each of the n = h * w
// cells of a block into out (uint32[n] on the current device), the cell at
// flat offset i having index origin + i, at counter word c1 under the run's
// key (k0, k1), on `stream`.  n must be below 2^32 (one block of draws).
int mc_cell_uniforms(void* out, long long n, uint32_t k0, uint32_t k1, uint32_t c1,
                     unsigned long long origin, int word, void* stream) {
  if (n < 1 || n > (1ll << 32) || (word != 0 && word != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cell_uniforms_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, k0, k1, c1, origin, word);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K6: one half-sweep of parity `parity` of the packed board x
// (uint32[h, wp] on the current device, wp = ceil(w / 32), the bits past
// column w zero) into y (a distinct buffer of the same shape), at counter
// word c1 (step * NSUB + the parity's substream) under the run's key,
// the board's cell (0, 0) at flat index origin, against the acceptance
// table's entries thr3 and thr4, on `stream`, by the wide instance where
// `wide` is 1 and the narrow one where it is 0.  h and w must be even, and
// a narrow launch's cells must lie below 2^32 (origin + h * w <= 2^32).
int mc_packed_metropolis_half(const void* x, void* y, int h, int w, int wp, int parity,
                              uint32_t k0, uint32_t k1, uint32_t c1, unsigned long long origin,
                              uint32_t thr3, uint32_t thr4, int wide, void* stream) {
  constexpr unsigned long long kBlock = 1ull << 32;
  if (h < 2 || w < 2 || (h & 1) || (w & 1) || wp != (w + 31) / 32 ||
      (parity != 0 && parity != 1) || x == y || (wide != 0 && wide != 1) ||
      (!wide && (origin > kBlock ||
                 static_cast<unsigned long long>(h) * static_cast<unsigned long long>(w) >
                     kBlock - origin))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(h) * wp;
  const Draws draws{k0, k1, c1, thr3, thr4};
  const NarrowHash narrow = narrow_hash(k0, k1, c1);
  const auto kernel =
      wide ? packed_metropolis_half_kernel<true> : packed_metropolis_half_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), h, w, wp, parity, origin,
      draws, narrow);
  return static_cast<int>(cudaGetLastError());
}

// K6's batch mode: one half-sweep of parity `parity` of every slot of the
// packed batch x (uint32[slots, h, wp] on the current device) into y (a
// distinct buffer of the same shape), at `offset` sweeps into the chunk,
// each slot's state read from the device arrays k0, k1, counter, rem (of
// length slots) and thr (slots rows of 5), each board's cell (0, 0) at
// flat index origin, on `stream`, by the wide instance where `wide` is 1
// and the narrow one where it is 0 (whose cells must lie below 2^32).
int mc_packed_metropolis_batch(const void* x, void* y, int slots, int h, int w, int wp,
                               int parity, const void* k0, const void* k1, const void* counter,
                               const void* thr, const void* rem, int offset,
                               unsigned long long origin, int wide, void* stream) {
  constexpr unsigned long long kBlock = 1ull << 32;
  if (slots < 1 || slots > kMaxSlots || offset < 0 || h < 2 || w < 2 || (h & 1) || (w & 1) ||
      wp != (w + 31) / 32 || (parity != 0 && parity != 1) || x == y ||
      (wide != 0 && wide != 1) ||
      (!wide && (origin > kBlock ||
                 static_cast<unsigned long long>(h) * static_cast<unsigned long long>(w) >
                     kBlock - origin))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BatchSlots state{static_cast<const uint32_t*>(k0), static_cast<const uint32_t*>(k1),
                         static_cast<const uint32_t*>(counter),
                         static_cast<const uint32_t*>(thr), static_cast<const int*>(rem)};
  const long long groups = static_cast<long long>(h) * ((wp + kGroup - 1) / kGroup);
  const dim3 grid(blocks_for(groups, kBatchThreads), slots);
  const auto kernel =
      wide ? packed_metropolis_batch_kernel<true> : packed_metropolis_batch_kernel<false>;
  kernel<<<grid, kBatchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), h, w, wp, parity, origin,
      state, offset, 1u);
  return static_cast<int>(cudaGetLastError());
}

// K7's batch mode: word 0 of the hash of each of the n cells of every
// slot's board into out (uint32[slots, n] on the current device), the cell
// at flat offset i having index i, under each slot's key at its counter
// word at `offset` sweeps into the chunk in `substream` (zeros for a
// frozen slot), each slot's state read from the device arrays k0, k1,
// counter and rem, on `stream`.  n must be at most 2^32.
int mc_cell_uniforms_batch(void* out, int slots, long long n, const void* k0, const void* k1,
                           const void* counter, const void* rem, int substream, int offset,
                           void* stream) {
  if (slots < 1 || slots > kMaxSlots || n < 1 || n > (1ll << 32) || offset < 0 ||
      substream < 0 || substream >= static_cast<int>(kNsub)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BatchSlots state{static_cast<const uint32_t*>(k0), static_cast<const uint32_t*>(k1),
                         static_cast<const uint32_t*>(counter), nullptr,
                         static_cast<const int*>(rem)};
  const dim3 grid(blocks_for((n + kDraws - 1) / kDraws, kBatchThreads), slots);
  cell_uniforms_batch_kernel<<<grid, kBatchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, state, static_cast<uint32_t>(substream), offset, 1u);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
