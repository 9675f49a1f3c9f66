// Int8 tiled multi-step kernels for Hopper (sm_90a): kernels K2 and K4.
//
// K2 replaces the TPU kernel make_pallas_multi_step with its bodies
// _vmem_counts and _int8_substeps and the frame re-zeroing _zero_frame
// (tpu_life/backends/pallas_backend.py).  It computes `k` masked steps of
// an unframed, contiguous int8[H, W] board of states 0 .. C-1, each equal
// to stencil.make_masked_step(rule, (H, W)) of tpu_life_torch/ops/stencil.py
// on the whole board, for any clamped Moore rule: radius r >= 1, the centre
// counted or not, 2 to 10 states.  Only state 1 is alive; the dying states
// of Generations count as dead.  Cells outside the board are dead and stay
// dead.  A cell holding a state outside 0 .. C-1 is not valid input.
//
// K4 replaces the TPU kernel make_pallas_sharded_int8_block (same file): K2
// per shard of the sharded backend.  It computes the same `k` masked steps
// of one shard's chunk, int8[rows, cols] holding the board's cells from
// board coordinate (row_org, col_org), from the chunk and its halos, which
// the exchange of parallel/halo.py filled from the neighbouring shards:
// `top` and `bot` (fr = r*k rows of the chunk's width each) and, on a mesh
// of columns, `left` and `right` (fr + rows + fr rows of fc = r*k columns
// each, corners included).  The TPU kernel takes one extended chunk that
// its epoch loop concatenates every block; K4 reads the pieces where they
// lie, as K3 does, so no block copies the chunk.  Cells of the board
// outside the chunk and its halos read zero; cells off the board, among
// them the padding rows and columns of the last shards, are pinned dead
// by the same mask as K2's, taken at the board coordinate.
//
// The two share every substep (int8_tile, templated on the window's
// source): K2's source is the board (BoardSrc: zero outside it, 16-byte
// loads where aligned), K4's the chunk and its halos (ShardSrc: scalar
// loads).  Each source also names the board coordinate of output cell
// (0, 0) for the mask; K2's is (0, 0).
//
// Layout of one block: an output tile of tile_rows x tile_cols cells,
// loaded with a halo of h = r*k cells on every side into shared memory
// (window column 0 is rounded down to a multiple of 4 for word stores).
// The wrapper (kernels/int8_tiled.py: window, shared_bytes) picks the
// window's columns, its row pitches and the bytes of shared memory, and
// passes them in; the kernel places its buffers from them.
// Loads outside the board read zero, in place of the TPU kernel's zero
// frame, so the board needs no frame and nothing re-zeroes one.  The block
// then runs k substeps in shared memory, ping-ponging two int8 buffers.
// Substep s (1-based) computes only the window shrunk by r*s on every side:
// the cells whose inputs are still exact.  After k substeps the tile, h
// cells in from every side, is exact.
//
// One substep is two passes, separable as on the TPU:
//   1. vertical: V[i][j] = number of alive cells in rows i-r .. i+r of
//      column j, a running window down a segment of rows (add the entering
//      row, subtract the leaving one), into an int16 buffer;
//   2. horizontal: the box sum as a running window along a segment of a row
//      of V, minus the centre unless the rule counts it; then the next state
//      is lut[state][count], read from a shared copy of the rule's
//      transition table (so one build serves every rule), and every cell
//      outside the board is written dead.  That mask runs after every
//      substep: a rule may give birth just past the edge (Larger-than-Life
//      B34..45 next to a full edge), and such a cell must not live to feed
//      the next substep's counts.
// The running windows keep the cost per cell independent of r.
//
// What bounds it on an H100: per cell and substep the function needs some
// seven 32-bit integer operations (alive test, the two running windows,
// the centre, the table index and read, the mask; int_ops_per_cell_step
// in kernels/int8_tiled.py) against 2 bytes of device memory per pass of k
// substeps.  At k = 8 the integer issue outweighs the memory traffic some
// 6-fold, so the kernel is issue-bound; each cell also makes about eight
// shared-memory accesses per substep, and the window's halo recomputes
// h cells on every side.  The design keeps device-memory traffic at one
// read and one write per cell per k substeps and leaves the rest to later
// work (four cells per 32-bit word, rules compiled in).  K4 at k = 1
// (bugs, r = 5) is bound by its bytes instead, and its scalar loads of the
// chunk and halos are the first thing to widen (ROADMAP A3).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;                 // cells per running-window segment

// A window source provides, for output coordinates (gr, gc) (the board's
// for K2, the chunk's for K4):
// - load(cur, grow0, gcol0, ext_r, ext_c, p8): the window of ext_r x ext_c
//   cells from (grow0, gcol0) into shared memory at row pitch p8;
// - row_in(gr), col_in(gc): whether the cell lies on the board.

// K2: the board is the output; zero outside it.
struct BoardSrc {
  const int8_t* __restrict__ src;
  int height;
  int width;
  int vec;  // 16-byte loads: width % 16 == 0 and a 16-byte aligned board

  __device__ __forceinline__ bool row_in(int gr) const { return gr >= 0 && gr < height; }
  __device__ __forceinline__ bool col_in(int gc) const { return gc >= 0 && gc < width; }

  __device__ __forceinline__ void load(int8_t* cur, int grow0, int gcol0, int ext_r,
                                       int ext_c, int p8) const {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (vec) {
      // a 16-byte chunk lies wholly inside or wholly outside the board
      const int g16 = gcol0 & ~15;
      const int nch = (gcol0 + ext_c - g16 + 15) / 16;
      for (int i = warp; i < ext_r; i += kWarps) {
        const int gr = grow0 + i;
        const bool in = row_in(gr);
        for (int c = lane; c < nch; c += 32) {
          const int g = g16 + 16 * c;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (in && g >= 0 && g < width) {
            v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(gr) * width + g));
          }
          const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int sc = g + 4 * q - gcol0;
            if (sc >= 0 && sc < ext_c) {
              *reinterpret_cast<uint32_t*>(cur + i * p8 + sc) = words[q];
            }
          }
        }
      }
    } else {
      for (int i = warp; i < ext_r; i += kWarps) {
        const int gr = grow0 + i;
        const bool in = row_in(gr);
        for (int c = lane; c < ext_c; c += 32) {
          const int gc = gcol0 + c;
          cur[i * p8 + c] = (in && col_in(gc)) ? src[static_cast<size_t>(gr) * width + gc]
                                               : static_cast<int8_t>(0);
        }
      }
    }
  }
};

// K4: one shard.  Chunk rows v in [0, rows) and columns u in [0, cols);
// row v of the extended chunk, v in [-fr, rows + fr), is top[v + fr],
// chunk[v] or bot[v - rows]; columns u in [-fc, 0) and [cols, cols + fc)
// are left[v + fr][u + fc] and right[v + fr][u - cols] (fc = 0: none).
// Chunk cell (v, u) is board cell (row_org + v, col_org + u).
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
  int row_org;
  int col_org;
  int height;  // the board's
  int width;

  __device__ __forceinline__ bool row_in(int v) const {
    const int g = row_org + v;
    return g >= 0 && g < height;
  }
  __device__ __forceinline__ bool col_in(int u) const {
    const int g = col_org + u;
    return g >= 0 && g < width;
  }

  __device__ __forceinline__ void load(int8_t* cur, int grow0, int gcol0, int ext_r,
                                       int ext_c, int p8) const {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int i = warp; i < ext_r; i += kWarps) {
      const int v = grow0 + i;
      const int8_t* mid = nullptr;  // the row's cells in [0, cols)
      const int8_t* lrow = nullptr;
      const int8_t* rrow = nullptr;
      if (v >= -fr && v < rows + fr) {
        if (v < 0) {
          mid = top + static_cast<size_t>(v + fr) * cols;
        } else if (v < rows) {
          mid = chunk + static_cast<size_t>(v) * cols;
        } else {
          mid = bot + static_cast<size_t>(v - rows) * cols;
        }
        if (fc > 0) {
          lrow = left + static_cast<size_t>(v + fr) * fc;
          rrow = right + static_cast<size_t>(v + fr) * fc;
        }
      }
      for (int c = lane; c < ext_c; c += 32) {
        const int u = gcol0 + c;
        int8_t x = 0;
        if (mid != nullptr) {
          if (u >= 0 && u < cols) {
            x = mid[u];
          } else if (u < 0 && u >= -fc) {
            x = lrow[u + fc];
          } else if (u >= cols && u < cols + fc) {
            x = rrow[u - cols];
          }
        }
        cur[i * p8 + c] = x;
      }
    }
  }
};

// k substeps of one output tile: the window from `src`, the tile back to
// dst (int8[out_rows, out_cols]).  ext_c: window columns (a multiple of 4,
// at least tile_cols + 2*halo + 3); p8, pv: the row pitches of the int8
// buffers and of the int16 sums in bytes (multiples of 4 and of 2);
// ncount: the table's columns, max_count + 1; vec: 16-byte stores
// (out_cols % 16 == 0, tile_cols % 16 == 0 and a 16-byte aligned dst).
template <class Src>
__device__ __forceinline__ void int8_tile(const Src& src, int8_t* __restrict__ dst,
                                          int out_rows, int out_cols,
                                          const int8_t* __restrict__ lut, int radius, int k,
                                          int include_center, int states, int ncount,
                                          int tile_rows, int tile_cols, int ext_c, int p8,
                                          int pv, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = radius * k;
  const int ext_r = tile_rows + 2 * halo;
  int8_t* cur = reinterpret_cast<int8_t*>(smem);
  int8_t* nxt = cur + ext_r * p8;
  int16_t* vsum = reinterpret_cast<int16_t*>(smem + 2 * ext_r * p8);
  int8_t* table = reinterpret_cast<int8_t*>(smem + 2 * ext_r * p8 + 2 * ext_r * pv);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = static_cast<int>(blockIdx.y) * tile_rows;  // first output row
  const int col0 = static_cast<int>(blockIdx.x) * tile_cols;  // first output column
  const int grow0 = row0 - halo;           // output row of window row 0
  const int gcol0 = (col0 - halo) & ~3;    // output column of window column 0

  for (int i = tid; i < states * ncount; i += kThreads) table[i] = lut[i];

  // -- the window ------------------------------------------------------------
  src.load(cur, grow0, gcol0, ext_r, ext_c, p8);
  __syncthreads();

  for (int s = 1; s <= k; ++s) {
    const int lo = s * radius;          // first exact window row/column after s
    const int nrows = ext_r - 2 * lo;   // rows computed in this substep

    // -- 1. vertical running window over columns [lo - r, ext_c - lo + r) --
    {
      const int c_begin = lo - radius;
      const int ncols = ext_c - 2 * c_begin;
      const int nseg = (nrows + kSeg - 1) / kSeg;
      for (int q = tid; q < ncols * nseg; q += kThreads) {
        const int c = c_begin + q % ncols;
        const int i0 = lo + (q / ncols) * kSeg;
        const int i1 = min(i0 + kSeg, ext_r - lo);
        const int8_t* col = cur + c;
        int sum = 0;
        for (int i = i0 - radius; i < i0 + radius; ++i) sum += col[i * p8] == 1;
        for (int i = i0; i < i1; ++i) {
          sum += col[(i + radius) * p8] == 1;
          vsum[i * pv + c] = static_cast<int16_t>(sum);
          sum -= col[(i - radius) * p8] == 1;
        }
      }
    }
    __syncthreads();

    // -- 2. horizontal running window, the rule and the board mask ---------
    {
      const int ncols = ext_c - 2 * lo;
      const int nseg = (ncols + kSeg - 1) / kSeg;
      for (int q = tid; q < nrows * nseg; q += kThreads) {
        const int i = lo + q % nrows;   // consecutive threads, consecutive rows
        const int j0 = lo + (q / nrows) * kSeg;
        const int j1 = min(j0 + kSeg, ext_c - lo);
        const bool row_in = src.row_in(grow0 + i);
        const int16_t* vrow = vsum + i * pv;
        const int8_t* crow = cur + i * p8;
        int8_t* nrow = nxt + i * p8;
        int sum = 0;
        for (int j = j0 - radius; j < j0 + radius; ++j) sum += vrow[j];
        for (int j = j0; j < j1; ++j) {
          sum += vrow[j + radius];
          const int state = crow[j];
          const int count = include_center ? sum : sum - (state == 1);
          const unsigned row =
              min(static_cast<unsigned>(state), static_cast<unsigned>(states - 1));
          nrow[j] = (row_in && src.col_in(gcol0 + j)) ? table[row * ncount + count]
                                                       : static_cast<int8_t>(0);
          sum -= vrow[j - radius];
        }
      }
    }
    __syncthreads();
    int8_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // -- the tile back to the output ----------------------------------------
  const int sc0 = col0 - gcol0;  // window column of the tile's first column
  if (vec) {
    // tile_cols % 16 == 0: 16-byte chunks, wholly inside or outside the output
    const int nch = tile_cols / 16;
    for (int i = warp; i < tile_rows; i += kWarps) {
      const int gr = row0 + i;
      if (gr >= out_rows) break;
      const uint32_t* srow = reinterpret_cast<const uint32_t*>(cur + (halo + i) * p8 + sc0);
      for (int c = lane; c < nch; c += 32) {
        const int g = col0 + 16 * c;
        if (g < out_cols) {
          const uint4 v = make_uint4(srow[4 * c], srow[4 * c + 1], srow[4 * c + 2],
                                     srow[4 * c + 3]);
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(gr) * out_cols + g) = v;
        }
      }
    }
  } else {
    for (int i = warp; i < tile_rows; i += kWarps) {
      const int gr = row0 + i;
      if (gr >= out_rows) break;
      for (int c = lane; c < tile_cols; c += 32) {
        const int gc = col0 + c;
        if (gc < out_cols) {
          dst[static_cast<size_t>(gr) * out_cols + gc] = cur[(halo + i) * p8 + sc0 + c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
int8_tiled_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                  const int8_t* __restrict__ lut, int height, int width,
                  int radius, int k, int include_center, int states, int ncount,
                  int tile_rows, int tile_cols, int ext_c, int p8, int pv,
                  int vec) {
  int8_tile(BoardSrc{src, height, width, vec}, dst, height, width, lut, radius, k,
            include_center, states, ncount, tile_rows, tile_cols, ext_c, p8, pv, vec);
}

__global__ void __launch_bounds__(kThreads)
sharded_int8_kernel(const int8_t* __restrict__ top, const int8_t* __restrict__ chunk,
                    const int8_t* __restrict__ bot, const int8_t* __restrict__ left,
                    const int8_t* __restrict__ right, int8_t* __restrict__ dst,
                    const int8_t* __restrict__ lut, int rows, int cols, int fr, int fc,
                    int row_org, int col_org, int height, int width, int radius, int k,
                    int include_center, int states, int ncount, int tile_rows,
                    int tile_cols, int ext_c, int p8, int pv, int vec) {
  int8_tile(ShardSrc{top, chunk, bot, left, right, rows, cols, fr, fc, row_org, col_org,
                     height, width},
            dst, rows, cols, lut, radius, k, include_center, states, ncount, tile_rows,
            tile_cols, ext_c, p8, pv, vec);
}

// Launch `kernel` over the tiles of rows x cols output cells with `smem`
// bytes of dynamic shared memory; returns cudaGetLastError() (or the error
// of setting the shared-memory size).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int rows, int cols, int tile_rows, int tile_cols, int smem,
           void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cols + tile_cols - 1) / tile_cols, (rows + tile_rows - 1) / tile_rows);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel K2: k masked steps from src into dst (distinct contiguous
// int8[height, width] buffers on the current device), with lut the rule's
// transition table int8[states, ncount] on the device, on `stream`.
// ext_c, p8 and pv are the window's layout (see int8_tile) and smem its
// dynamic shared memory: two buffers of (tile_rows + 2*radius*k) x p8
// bytes, the int16 sums at pitch pv and the table.  vec != 0 asks for
// 16-byte loads and stores: width % 16 == 0, tile_cols % 16 == 0 and
// 16-byte aligned buffers.  Returns cudaGetLastError() (or the error of
// setting the shared-memory size).
int int8_tiled_multi_step(const void* src, void* dst, const void* lut,
                          int height, int width, int radius, int k,
                          int include_center, int states, int ncount,
                          int tile_rows, int tile_cols, int ext_c, int p8,
                          int pv, int smem, int vec, void* stream) {
  return launch(int8_tiled_kernel, height, width, tile_rows, tile_cols, smem, stream,
                static_cast<const int8_t*>(src), static_cast<int8_t*>(dst),
                static_cast<const int8_t*>(lut), height, width, radius, k, include_center,
                states, ncount, tile_rows, tile_cols, ext_c, p8, pv, vec);
}

// Kernel K4: k masked steps of one shard, from chunk (int8[rows, cols]) and
// its halos top and bot (int8[fr, cols] each, fr = radius * k) and, where
// fc > 0, left and right (int8[fr + rows + fr, fc] each, fc = radius * k;
// null where fc = 0) into dst (int8[rows, cols], none of the inputs), on
// `stream`.  (row0, col0) is the board coordinate of top[0][0]'s row and
// of left's column 0 (of the chunk's column 0 where fc = 0), and the board
// is height x width.  The table, window layout and vec (16-byte stores
// only: cols % 16 == 0, tile_cols % 16 == 0, a 16-byte aligned dst) as
// for K2.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments outside these.
int sharded_int8_block(const void* top, const void* chunk, const void* bot,
                       const void* left, const void* right, void* dst, const void* lut,
                       int rows, int cols, int fr, int fc, int row0, int col0,
                       int height, int width, int radius, int k, int include_center,
                       int states, int ncount, int tile_rows, int tile_cols, int ext_c,
                       int p8, int pv, int smem, int vec, void* stream) {
  if (rows < 1 || cols < 1 || k < 1 || fr != radius * k || (fc != 0 && fc != fr) ||
      ((left == nullptr || right == nullptr) != (fc == 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(sharded_int8_kernel, rows, cols, tile_rows, tile_cols, smem, stream,
                static_cast<const int8_t*>(top), static_cast<const int8_t*>(chunk),
                static_cast<const int8_t*>(bot), static_cast<const int8_t*>(left),
                static_cast<const int8_t*>(right), static_cast<int8_t*>(dst),
                static_cast<const int8_t*>(lut), rows, cols, fr, fc, row0 + fr, col0 + fc,
                height, width, radius, k, include_center, states, ncount, tile_rows,
                tile_cols, ext_c, p8, pv, vec);
}

}  // extern "C"
