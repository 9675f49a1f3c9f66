// Int8 tiled multi-step kernel for Hopper (sm_90a): kernel K2.
//
// Replaces the TPU kernel make_pallas_multi_step with its bodies
// _vmem_counts and _int8_substeps and the frame re-zeroing _zero_frame
// (tpu_life/backends/pallas_backend.py).  It computes `k` masked steps of
// an unframed, contiguous int8[H, W] board of states 0 .. C-1, each equal
// to stencil.make_masked_step(rule, (H, W)) of tpu_life_torch/ops/stencil.py
// on the whole board, for any clamped Moore rule: radius r >= 1, the centre
// counted or not, 2 to 10 states.  Only state 1 is alive; the dying states
// of Generations count as dead.  Cells outside the board are dead and stay
// dead.  A cell holding a state outside 0 .. C-1 is not valid input.
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
// work (four cells per 32-bit word, rules compiled in).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;                 // cells per running-window segment

// ext_c: window columns (a multiple of 4, at least tile_cols + 2*halo + 3);
// p8, pv: the row pitches of the int8 buffers and of the int16 sums in
// bytes (multiples of 4 and of 2); ncount: the table's columns,
// max_count + 1.
__global__ void __launch_bounds__(kThreads)
int8_tiled_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                  const int8_t* __restrict__ lut, int height, int width,
                  int radius, int k, int include_center, int states, int ncount,
                  int tile_rows, int tile_cols, int ext_c, int p8, int pv,
                  int vec) {
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
  const int grow0 = row0 - halo;           // board row of window row 0
  const int gcol0 = (col0 - halo) & ~3;    // board column of window column 0

  for (int i = tid; i < states * ncount; i += kThreads) table[i] = lut[i];

  // -- the window, zeros outside the board --------------------------------
  if (vec) {
    // width % 16 == 0 and 16-byte aligned rows: a 16-byte chunk lies wholly
    // inside or wholly outside the board
    const int g16 = gcol0 & ~15;
    const int nch = (gcol0 + ext_c - g16 + 15) / 16;
    for (int i = warp; i < ext_r; i += kWarps) {
      const int gr = grow0 + i;
      const bool row_in = gr >= 0 && gr < height;
      for (int c = lane; c < nch; c += 32) {
        const int g = g16 + 16 * c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row_in && g >= 0 && g < width) {
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
      const bool row_in = gr >= 0 && gr < height;
      for (int c = lane; c < ext_c; c += 32) {
        const int gc = gcol0 + c;
        cur[i * p8 + c] = (row_in && gc >= 0 && gc < width)
                              ? src[static_cast<size_t>(gr) * width + gc]
                              : static_cast<int8_t>(0);
      }
    }
  }
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
        const int gr = grow0 + i;
        const bool row_in = gr >= 0 && gr < height;
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
          const int gc = gcol0 + j;
          nrow[j] = (row_in && gc >= 0 && gc < width) ? table[row * ncount + count]
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

  // -- the tile back to the board -----------------------------------------
  const int sc0 = col0 - gcol0;  // window column of the tile's first column
  if (vec) {
    // tile_cols % 16 == 0: 16-byte chunks, wholly inside or outside the board
    const int nch = tile_cols / 16;
    for (int i = warp; i < tile_rows; i += kWarps) {
      const int gr = row0 + i;
      if (gr >= height) break;
      const uint32_t* srow = reinterpret_cast<const uint32_t*>(cur + (halo + i) * p8 + sc0);
      for (int c = lane; c < nch; c += 32) {
        const int g = col0 + 16 * c;
        if (g < width) {
          const uint4 v = make_uint4(srow[4 * c], srow[4 * c + 1], srow[4 * c + 2],
                                     srow[4 * c + 3]);
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(gr) * width + g) = v;
        }
      }
    }
  } else {
    for (int i = warp; i < tile_rows; i += kWarps) {
      const int gr = row0 + i;
      if (gr >= height) break;
      for (int c = lane; c < tile_cols; c += 32) {
        const int gc = col0 + c;
        if (gc < width) {
          dst[static_cast<size_t>(gr) * width + gc] = cur[(halo + i) * p8 + sc0 + c];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// k masked steps from src into dst (distinct contiguous int8[height, width]
// buffers on the current device), with lut the rule's transition table
// int8[states, ncount] on the device, on `stream`.  ext_c, p8 and pv are
// the window's layout (see the kernel) and smem its dynamic shared memory:
// two buffers of (tile_rows + 2*radius*k) x p8 bytes, the int16 sums at
// pitch pv and the table.  vec != 0 asks for 16-byte loads and stores:
// width % 16 == 0, tile_cols % 16 == 0 and 16-byte aligned buffers.
// Returns cudaGetLastError() (or the error of setting the shared-memory
// size).
int int8_tiled_multi_step(const void* src, void* dst, const void* lut,
                          int height, int width, int radius, int k,
                          int include_center, int states, int ncount,
                          int tile_rows, int tile_cols, int ext_c, int p8,
                          int pv, int smem, int vec, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + tile_cols - 1) / tile_cols,
                  (height + tile_rows - 1) / tile_rows);
  int8_tiled_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst),
      static_cast<const int8_t*>(lut), height, width, radius, k, include_center,
      states, ncount, tile_rows, tile_cols, ext_c, p8, pv, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
