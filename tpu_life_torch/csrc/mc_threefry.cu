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
// One thread a word, all in registers: it reads its word and the four torus
// neighbour words (rows mod h; the column seam at the logical width w, not
// at 32 * wp), reduces the four neighbour planes by carry-save adders to the
// bit planes of the count, forms the planes needs3 and needs4 (the cells
// whose table index (s * nsum + 4) >> 1 is 3 or 4; the rest force-accept),
// hashes the word's active-parity cells (columns a + 2t, a = (r + parity) &
// 1, those at c < w only: the plain version pads the row with draws the
// column mask never consumes), compares each draw unsigned against the
// table's entries 3 and 4, and writes x ^ (accept & parity mask & column
// mask).  The odd half reads the even half's result, so a sweep is two
// launches.  Its plain version is mc/packed.py::half_sweep_torch.  Bound on
// an H100: the function needs the draw of an active cell only where the
// table decides its move (dE > 0: 5/16 of a random board's active cells,
// most of a lattice ordering near T_c), 39 integer-pipe operations each
// (word 0's 37, the select of the table entry that the cell's index names
// and one unsigned compare), and some 18 logic operations a word; the
// words read and written weigh less, so operations bound it.
// This first kernel hashes every active cell, decided or not (ROADMAP
// A3.7).
//
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments outside what
// they take).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kWideKeyTag = 0xFFFFFFFFu;
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
    packed_metropolis_half_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                  int h, int w, int wp, int parity, uint32_t k0, uint32_t k1,
                                  uint32_t c1, unsigned long long origin, uint32_t thr3,
                                  uint32_t thr4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(h) * wp) return;
  const int r = static_cast<int>(i / wp);
  const int j = static_cast<int>(i - static_cast<long long>(r) * wp);
  const uint32_t* row = x + static_cast<long long>(r) * wp;
  const uint32_t c = row[j];
  const uint32_t up = x[static_cast<long long>(r + 1 == h ? 0 : r + 1) * wp + j];
  const uint32_t down = x[static_cast<long long>(r == 0 ? h - 1 : r - 1) * wp + j];
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
  const uint32_t needs3 = (c & n3) | (~c & n1);
  const uint32_t needs4 = (c & b2) | (~c & n0);
  // the draws of the active-parity cells of this word
  const int a = (r + parity) & 1;
  const int cols = min(32, w - 32 * j);  // valid columns in this word
  const unsigned long long base =
      origin + static_cast<unsigned long long>(r) * static_cast<unsigned long long>(w) +
      32ull * static_cast<unsigned long long>(j) + static_cast<unsigned long long>(a);
  uint32_t key_hi = 0;
  uint2 key = make_uint2(k0, k1);
  uint32_t cmp3 = 0, cmp4 = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int bit = a + 2 * t;
    if (bit < cols) {
      const unsigned long long idx = base + 2ull * static_cast<unsigned long long>(t);
      const uint32_t hi = static_cast<uint32_t>(idx >> 32);
      if (hi != key_hi) {
        key = block_key(k0, k1, hi);
        key_hi = hi;
      }
      const uint32_t u = threefry2x32(key.x, key.y, static_cast<uint32_t>(idx), c1).x;
      cmp3 |= static_cast<uint32_t>(u < thr3) << bit;
      cmp4 |= static_cast<uint32_t>(u < thr4) << bit;
    }
  }
  const uint32_t accept = ~(needs3 | needs4) | (needs3 & cmp3) | (needs4 & cmp4);
  const uint32_t pmask = a ? 0xAAAAAAAAu : 0x55555555u;
  const uint32_t cmask = cols == 32 ? 0xFFFFFFFFu : (1u << cols) - 1u;
  y[i] = c ^ (accept & pmask & cmask);
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
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
// table's entries thr3 and thr4, on `stream`.  h and w must be even.
int mc_packed_metropolis_half(const void* x, void* y, int h, int w, int wp, int parity,
                              uint32_t k0, uint32_t k1, uint32_t c1, unsigned long long origin,
                              uint32_t thr3, uint32_t thr4, void* stream) {
  if (h < 2 || w < 2 || (h & 1) || (w & 1) || wp != (w + 31) / 32 ||
      (parity != 0 && parity != 1) || x == y) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(h) * wp;
  packed_metropolis_half_kernel<<<blocks_for(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), h, w, wp, parity, k0, k1, c1,
      origin, thr3, thr4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
