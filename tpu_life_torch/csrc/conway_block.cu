// Int8 Conway block kernel for Hopper (sm_90a): kernel K5.
//
// K5 replaces the TPU kernel conway_pallas / make_kernel with its substep
// _life_substep (experiments/pallas_bench.py).  It computes what that
// kernel computes on its domain: k clamped Conway steps (born on 3
// neighbours, survives on 2 or 3; the rule is compiled in, where K2 reads a
// transition table) of a contiguous int8[n, n] board of cells 0 and 1, in
// one launch.  Cells outside the board are dead and stay dead.  A cell
// holding another value than 0 or 1 is not valid input.
//
// The TPU kernel gives each program one bh-row, full-width block plus k
// halo rows in VMEM.  A full-width window does not fit a Hopper block's
// shared memory (272 x 8192 bytes at the experiment's defaults against 227
// KB), so the tile here is the port's own: a 2-D output tile of kTileRows x
// tile_cols cells, loaded with a halo of k rows above and below and hc =
// ceil4(k) columns on each side, a window of exactly kWords 32-bit words
// (256 cells) a row.  Loads outside the board read zero, so the board needs
// no frame.  The block then runs the k substeps in shared memory,
// ping-ponging two buffers; substep s computes the window's rows s ..
// ext_rows - s - 1, whose inputs are still exact, and every word column,
// reading zero past the window's sides (the error that lets in stays hc >=
// k cells from the tile).  After every substep every cell outside the board
// is written dead: the TPU kernel's row mask (`valid`) and column mask
// (`col_ids`) in one.
//
// Four cells to a 32-bit word (byte b is column 4q + b), as plain integer
// arithmetic: a cell is 0 or 1, so the sums below stay under 16 in every
// byte and never carry into the next.  Per word and substep: the vertical
// sums of three rows in the word and its two neighbours (three adds), the
// neighbours' sums shifted in by a funnel shift each, the box sum (one
// three-input add), the neighbour count N = box - centre, then the rule:
// alive next iff (N | centre) == 3 (N == 3, or N == 2 and alive), tested
// per byte as ((N | centre) ^ 3) + 15 having bit 4 clear; and the board
// mask.  Some 12 integer operations a word of four cells (3 a cell and
// step), with three shared-memory loads and one store.  Each of the
// kThreads threads owns one word column of the window and a quarter of its
// rows, walking down them with the three rows it needs in registers.
//
// The function's own bound on an H100 is the bytes: one read and one
// write a cell a launch (Conway bit-sliced, as K1 runs it, needs some 15
// logic instructions a 32-cell word and step, under the bytes' time at k =
// 8).  This design issues more than that: its 3 operations a cell and step
// come to 24 a cell a launch at k = 8, some 2.4 times the bytes' time, and
// the halo recomputes ceil4(k) columns and k rows on each side of a tile
// (1.33x the cells at k = 8 with 64-row tiles, which take 42 KB of shared
// memory and keep 5 blocks on an SM).  Packing the cells to bits, wider
// tiles and wider loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // threads per block
constexpr int kWords = 64;                // window words a row: 256 cells
constexpr int kPitch = kWords + 2;        // a zero word on each side
constexpr int kGroups = kThreads / kWords;  // row groups: each thread's quarter
constexpr int kMaxDepth = 32;             // substeps a launch
constexpr int kTileRows = 64;             // output rows of a block

// 0x01 in each byte of the word at board column gc whose column lies on
// the board
__device__ __forceinline__ uint32_t column_mask(int gc, int n) {
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (gc + b >= 0 && gc + b < n) m |= 1u << (8 * b);
  }
  return m;
}

// The next state of the word whose rows above, at and below are up, mid
// and dn, each [left, centre, right] word; m: the board mask of the word.
__device__ __forceinline__ uint32_t next_word(const uint32_t (&up)[3],
                                              const uint32_t (&mid)[3],
                                              const uint32_t (&dn)[3], uint32_t m) {
  const uint32_t vl = up[0] + mid[0] + dn[0];
  const uint32_t vc = up[1] + mid[1] + dn[1];
  const uint32_t vr = up[2] + mid[2] + dn[2];
  // byte b of left is vc's byte b-1 (vl's byte 3 into byte 0), of right
  // vc's byte b+1 (vr's byte 0 into byte 3)
  const uint32_t left = __funnelshift_l(vl, vc, 8);
  const uint32_t right = __funnelshift_r(vc, vr, 8);
  const uint32_t count = vc + left + right - mid[1];  // the 8 neighbours
  const uint32_t y = (count | mid[1]) ^ 0x03030303u;  // 0 where alive next
  return ~((y + 0x0F0F0F0Fu) >> 4) & m;
}

__global__ void __launch_bounds__(kThreads)
conway_block_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst, int n, int k,
                    int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int hc = (k + 3) & ~3;                   // halo columns, whole words
  const int tile_cols = 4 * kWords - 2 * hc;
  const int ext_rows = kTileRows + 2 * k;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + ext_rows * kPitch;

  const int q = threadIdx.x % kWords;            // this thread's word column
  const int group = threadIdx.x / kWords;
  const int row0 = static_cast<int>(blockIdx.y) * kTileRows;  // first output row
  const int col0 = static_cast<int>(blockIdx.x) * tile_cols;  // first output column
  const int grow0 = row0 - k;                    // board row of window row 0
  const int gc = col0 - hc + 4 * q;              // board column of the word's byte 0
  const uint32_t cmask = column_mask(gc, n);

  // -- the window, and the zero words on its sides --------------------------
  for (int i = group; i < ext_rows; i += kGroups) {
    const int gr = grow0 + i;
    uint32_t w = 0;
    if (gr >= 0 && gr < n && cmask != 0) {
      const int8_t* row = src + static_cast<size_t>(gr) * n;
      if (vec) {  // n % 4 == 0, boards 4-byte aligned: the word lies wholly on the board
        w = __ldg(reinterpret_cast<const uint32_t*>(row + gc));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (cmask >> (8 * b) & 1u) w |= static_cast<uint32_t>(static_cast<uint8_t>(row[gc + b])) << (8 * b);
        }
      }
    }
    cur[i * kPitch + 1 + q] = w;
  }
  for (int i = threadIdx.x; i < 2 * ext_rows; i += kThreads) {
    const int side = (i & 1) ? kPitch - 1 : 0;
    cur[(i >> 1) * kPitch + side] = 0;
    nxt[(i >> 1) * kPitch + side] = 0;
  }
  __syncthreads();

  // -- k substeps ------------------------------------------------------------
  for (int s = 1; s <= k; ++s) {
    const int rows = ext_rows - 2 * s;           // rows s .. ext_rows - s - 1
    const int seg = (rows + kGroups - 1) / kGroups;
    const int i0 = s + group * seg;
    const int i1 = min(i0 + seg, s + rows);
    const uint32_t* in = cur + q;                // in[i * kPitch + 0..2]: left, centre, right
    uint32_t* out = nxt + 1 + q;
    auto load = [&](uint32_t (&r)[3], int i) {
      r[0] = in[i * kPitch];
      r[1] = in[i * kPitch + 1];
      r[2] = in[i * kPitch + 2];
    };
    auto emit = [&](const uint32_t (&up)[3], const uint32_t (&mid)[3],
                    const uint32_t (&dn)[3], int i) {
      const int gr = grow0 + i;
      out[i * kPitch] = next_word(up, mid, dn, (gr >= 0 && gr < n) ? cmask : 0u);
    };
    if (i0 < i1) {
      // three rows in registers, renamed by the unrolled body, not moved
      uint32_t a[3], b[3], c[3];
      load(a, i0 - 1);
      load(b, i0);
      int i = i0;
      for (; i + 3 <= i1; i += 3) {
        load(c, i + 1);
        emit(a, b, c, i);
        load(a, i + 2);
        emit(b, c, a, i + 1);
        load(b, i + 3);
        emit(c, a, b, i + 2);
      }
      if (i < i1) {
        load(c, i + 1);
        emit(a, b, c, i);
        if (i + 1 < i1) {
          load(a, i + 2);
          emit(b, c, a, i + 1);
        }
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // -- the tile back to the board ---------------------------------------------
  const int tq = q - hc / 4;                     // the word's column in the tile
  if (tq >= 0 && tq < tile_cols / 4 && cmask != 0) {
    for (int i = group; i < kTileRows; i += kGroups) {
      const int gr = row0 + i;
      if (gr >= n) break;
      const uint32_t w = cur[(k + i) * kPitch + 1 + q];
      int8_t* row = dst + static_cast<size_t>(gr) * n;
      if (vec) {
        *reinterpret_cast<uint32_t*>(row + gc) = w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (cmask >> (8 * b) & 1u) row[gc + b] = static_cast<int8_t>(w >> (8 * b) & 0xFFu);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Kernel K5: k clamped Conway steps (1 <= k <= 32) from src into dst
// (distinct contiguous int8[n, n] boards of 0s and 1s on the current
// device), in output tiles of kTileRows rows and 256 - 2 * ceil4(k)
// columns, on `stream`; with 32-bit loads and stores where n % 4 == 0 and
// both boards are 4-byte aligned.  Returns cudaGetLastError() (or the error
// of setting the shared-memory size), or cudaErrorInvalidValue for
// arguments outside these.
int conway_block(const void* src, void* dst, int n, int k, void* stream) {
  if (n < 1 || k < 1 || k > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(dst) % 4 == 0;
  const int hc = (k + 3) & ~3;
  const int tile_cols = 4 * kWords - 2 * hc;
  const int smem = 2 * (kTileRows + 2 * k) * kPitch * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      conway_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + tile_cols - 1) / tile_cols, (n + kTileRows - 1) / kTileRows);
  conway_block_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), n, k, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
