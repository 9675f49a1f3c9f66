// tpu-life native compute runtime: multithreaded LUT stencil stepper.
//
// The reference's compute layer is the nested-loop `countNeighbours` +
// `updateGrid` pair (Parallel_Life_MPI.cpp:16-54): ~9 branchy grid reads per
// cell over vector<vector<int>>.  This library is the framework's native CPU
// equivalent, generalized the same way the device kernels are: one engine
// driven by the rule's transition LUT (states x (max_count+1)) covering
// life-like, Generations, and Larger-than-Life radii, with clamped
// non-periodic boundaries (the reference's edge semantics, :21-27).
//
// Algorithm: separable sliding-window box sum — per row a horizontal
// (2r+1)-window running sum, per column a vertical ring-buffer accumulation —
// O(1) work per cell at any radius, then one LUT byte lookup per cell.
// Parallelism: POSIX threads over contiguous row blocks (the reference's MPI
// stripe decomposition collapsed into shared-memory threads); one barrier per
// generation is the only synchronization, replacing the per-epoch
// MPI_Barrier (:220).
//
// Exposed to Python via ctypes (tpu_life/ops/native_step.py); the NumPy
// executor remains the portable truth.  Error codes: 0 ok; -2 bad geometry.

#include <cstdint>
#include <cstring>
#include <pthread.h>

#include <algorithm>
#include <vector>

namespace {

struct Shared {
  int8_t* a;          // buffer 0 (caller's grid)
  int8_t* b;          // buffer 1 (scratch)
  long h, w;
  const int8_t* lut;  // [states][C]
  int C;              // max_count + 1
  int radius;
  int include_center;
  long steps;
  pthread_barrier_t barrier;
  // start gate: workers park here until the main thread knows every
  // pthread_create succeeded; on abort they exit before ever touching the
  // step barrier (whose participant count assumes a full roster)
  pthread_mutex_t mu;
  pthread_cond_t cv;
  int started;
  int abort_flag;
};

struct Worker {
  Shared* s;
  long r0, r1;  // row block [r0, r1)
};

// Horizontal clamped (2r+1)-window sum of the alive mask of `row`
// (alive = state 1 exactly; Generations decay states count as dead).
// Rows outside the board contribute zeros — callers pass row == nullptr.
void hsum_row(const int8_t* row, long w, int r, int16_t* out) {
  if (row == nullptr) {
    std::memset(out, 0, sizeof(int16_t) * w);
    return;
  }
  long s = 0;
  for (long j = 0; j <= std::min<long>(r, w - 1); ++j) s += (row[j] == 1);
  out[0] = static_cast<int16_t>(s);
  for (long j = 1; j < w; ++j) {
    const long add = j + r;
    if (add < w) s += (row[add] == 1);
    const long sub = j - r - 1;
    if (sub >= 0) s -= (row[sub] == 1);
    out[j] = static_cast<int16_t>(s);
  }
}

void run_block(Worker* wk) {
  Shared* s = wk->s;
  const long h = s->h, w = s->w;
  const int r = s->radius;
  const int win = 2 * r + 1;
  const int8_t* lut = s->lut;
  const int C = s->C;

  // ring of horizontal sums for rows [i-r, i+r], plus the vertical total
  std::vector<int16_t> ring(static_cast<size_t>(win) * w);
  std::vector<int32_t> vert(w);

  int8_t* cur = s->a;
  int8_t* nxt = s->b;
  for (long step = 0; step < s->steps; ++step) {
    // seed the window for the first row of this block
    std::fill(vert.begin(), vert.end(), 0);
    for (long i2 = wk->r0 - r; i2 <= wk->r0 + r; ++i2) {
      int16_t* slot = ring.data() + (((i2 % win) + win) % win) * w;
      hsum_row((i2 >= 0 && i2 < h) ? cur + i2 * w : nullptr, w, r, slot);
      for (long j = 0; j < w; ++j) vert[j] += slot[j];
    }
    for (long i = wk->r0; i < wk->r1; ++i) {
      const int8_t* crow = cur + i * w;
      int8_t* nrow = nxt + i * w;
      if (s->include_center) {
        for (long j = 0; j < w; ++j) nrow[j] = lut[crow[j] * C + vert[j]];
      } else {
        for (long j = 0; j < w; ++j)
          nrow[j] = lut[crow[j] * C + vert[j] - (crow[j] == 1)];
      }
      if (i + 1 < wk->r1) {  // slide the vertical window one row down
        const long drop = i - r, take = i + 1 + r;
        const int16_t* old_slot = ring.data() + (((drop % win) + win) % win) * w;
        for (long j = 0; j < w; ++j) vert[j] -= old_slot[j];
        int16_t* new_slot = ring.data() + (((take % win) + win) % win) * w;
        hsum_row((take < h) ? cur + take * w : nullptr, w, r, new_slot);
        for (long j = 0; j < w; ++j) vert[j] += new_slot[j];
      }
    }
    pthread_barrier_wait(&s->barrier);
    std::swap(cur, nxt);
  }
}

void* worker_main(void* arg) {
  auto* wk = static_cast<Worker*>(arg);
  Shared* s = wk->s;
  pthread_mutex_lock(&s->mu);
  while (!s->started) pthread_cond_wait(&s->cv, &s->mu);
  const int aborted = s->abort_flag;
  pthread_mutex_unlock(&s->mu);
  if (!aborted) run_block(wk);
  return nullptr;
}

}  // namespace

extern "C" {

// Advance `grid` (int8 h*w, row-major, states 0..states-1) `steps`
// generations in place.  `lut` is the rule transition table
// [states][max_count+1]; `max_count` = (2r+1)^2 - (include_center ? 0 : 1).
int tl_run(int8_t* grid, long h, long w, const int8_t* lut, int states,
           int max_count, int radius, int include_center, long steps,
           int threads) {
  if (h <= 0 || w <= 0 || states < 2 || radius < 1 || steps < 0) return -2;
  if (max_count < (2 * radius + 1) * (2 * radius + 1) - !include_center)
    return -2;
  if (steps == 0) return 0;

  std::vector<int8_t> scratch(static_cast<size_t>(h) * w);
  long t = std::max(1, threads);
  t = std::min(t, h);  // at least one row per thread

  Shared s;
  s.a = grid;
  s.b = scratch.data();
  s.h = h;
  s.w = w;
  s.lut = lut;
  s.C = max_count + 1;
  s.radius = radius;
  s.include_center = include_center;
  s.steps = steps;
  pthread_barrier_init(&s.barrier, nullptr, static_cast<unsigned>(t));
  pthread_mutex_init(&s.mu, nullptr);
  pthread_cond_init(&s.cv, nullptr);
  s.started = 0;
  s.abort_flag = 0;

  std::vector<Worker> workers(t);
  std::vector<pthread_t> tids(t);
  const long per = h / t, rem = h % t;
  long row = 0;
  for (long k = 0; k < t; ++k) {
    workers[k].s = &s;
    workers[k].r0 = row;
    row += per + (k < rem ? 1 : 0);
    workers[k].r1 = row;
  }
  long created = 0;
  for (long k = 1; k < t; ++k) {
    if (pthread_create(&tids[k], nullptr, worker_main, &workers[k]) != 0) break;
    ++created;
  }
  // release the gate; on a short roster the workers exit without stepping
  pthread_mutex_lock(&s.mu);
  s.started = 1;
  s.abort_flag = (created != t - 1);
  pthread_mutex_unlock(&s.mu);
  pthread_cond_broadcast(&s.cv);
  if (s.abort_flag) {
    for (long k = 1; k <= created; ++k) pthread_join(tids[k], nullptr);
    // degrade to single-threaded rather than failing the run
    pthread_barrier_destroy(&s.barrier);
    pthread_barrier_init(&s.barrier, nullptr, 1);
    Worker all{&s, 0, h};
    run_block(&all);
  } else {
    run_block(&workers[0]);
    for (long k = 1; k < t; ++k) pthread_join(tids[k], nullptr);
  }
  pthread_barrier_destroy(&s.barrier);
  pthread_cond_destroy(&s.cv);
  pthread_mutex_destroy(&s.mu);

  if (steps % 2 != 0)  // final state landed in the scratch buffer
    std::memcpy(grid, scratch.data(), static_cast<size_t>(h) * w);
  return 0;
}

}  // extern "C"
