// K10a: the barycentric interpolating gather, and K10b: its table and
// weight gradients.
//
// K10a replaces _fwd_kernel (pertrenderer_tpu/ops/interp_gather.py:75,
// pallas_call at :179):
//   out[:, p] = w0[p] t[idx[p], 0] + w1[p] t[idx[p], 1] + w2[p] t[idx[p], 2]
// for a row-major (F, 3, D) corner table, zero where idx[p] lies outside
// [0, F).  The TPU folds the weights into one-hot matmuls so that the
// (3D, P) corner tensor never reaches HBM; on Hopper one thread per column
// p reads its row's 3D contiguous floats (read-only path, L2-resident) and
// writes the D interpolated values, coalesced along p — nothing but the
// (D, P) result reaches device memory either.  Bound: bytes.  The sum is
// (t0 * (w0 * valid) + t1 * (w1 * valid)) + t2 * (w2 * valid), left to
// right and without contraction, as the plain version evaluates it.
//
// K10b replaces _bwd_tables_kernel (:101, pallas_call :222) and
// _bwd_weights_kernel (:127, pallas_call :243):
//   d_t[f, v] = sum_{p: idx[p] = f} w_v[p] g[:, p]
//   dw_v[p]   = sum_d t[idx[p], v, d] g[d, p]   (0 where idx[p] is outside)
// Bound: bytes — idx, the weights and dw once over every column, g once
// over the filled ones.  The design reads each of them once, in column
// order, and reads g only where a column is filled (a pixel's filled
// slots are contiguous, so whole sectors of the rest are never touched):
//  1. bwd_tile_kernel: a block per tile of 1024 consecutive columns, 256
//     threads.  It loads idx coalesced and compacts the
//     filled columns in column order (warp ballots), with their weights
//     staged in shared memory; a tile without one writes dw = 0 and
//     leaves.  It sorts the filled columns by face, stably, in shared
//     memory (an LSD radix sort of 8-bit digits: per-warp digit counts
//     and __match_any_sync ranks, as segment_sum.cuh's passes, but
//     block-local), then stages g of the filled columns (kStage channels
//     at a time, every load in flight at once) and, per run of one face,
//     sums w_v g over the run's columns in column order into one partial
//     row of 3D floats (row tile x 1024 + r of `part`, its face in
//     part_face, the run count in tile_rows, one integer increment of
//     face_count per run) and computes the run's columns' dw from the
//     face's table row, read once per run from L2 (the (F, 3, D) table
//     is 1.5 MB for the cow), the channels in order; dw is written for
//     every column, coalesced.
//  2. face_scan_kernel: the faces' starts in a list of partial rows
//     (an exclusive scan of face_count, one block).
//  3. face_fill_kernel: each partial row's id into its face's part of the
//     list (integer atomics: the order within a face is arbitrary here).
//  4. face_merge_kernel: a warp per face sorts its row ids (each lane
//     ranks its ids against the others; a face has at most one row per
//     tile, so the order is the tiles' order) and adds its partials in
//     that order, a lane per component; a face without rows is an exact 0.
// No float atomics: the bits are the same from run to run.  Every sum
// starts at +0 and adds in column order within a tile, then in tile order
// (ops/interp_gather.py interp_rows_backward_tiles_plain, the plain mirror
// of this order).  The partial rows are laid out for the worst case, a
// tile of distinct faces: P rows of 3D floats, of which each tile fills
// its run count.
//
// Numerics: -fmad=false and no fast math (_build.py).
#include <cuda_runtime.h>
#include <limits.h>

#include "segment_sum.cuh"

namespace {

__device__ __forceinline__ long long safe_row(long long i, int f,
                                              float* valid) {
  *valid = (i >= 0 && i < f) ? 1.0f : 0.0f;
  return i < 0 ? 0 : (i >= f ? f - 1 : i);
}

__global__ void interp_fwd_kernel(const float* __restrict__ table,
                                  const long long* __restrict__ idx,
                                  const float* __restrict__ w0,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ w2,
                                  float* __restrict__ out, long long p_total,
                                  int f, int d) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_total) return;
  float valid;
  const long long r = safe_row(idx[p], f, &valid);
  const float a0 = w0[p] * valid, a1 = w1[p] * valid, a2 = w2[p] * valid;
  const float* row = table + r * 3 * d;
  for (int j = 0; j < d; ++j) {
    const float t0 = __ldg(row + j), t1 = __ldg(row + d + j),
                t2 = __ldg(row + 2 * d + j);
    out[(long long)j * p_total + p] = (t0 * a0 + t1 * a1) + t2 * a2;
  }
}

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kTileItems = 4;                  // columns a thread
constexpr int kTile = kBwdThreads * kTileItems;
constexpr int kStage = 6;                      // channels of g staged at once

// The tile kernel's shared memory in 4-byte words: keys (2 kTile), items
// (2 kTile), per-warp digit counts (8 x 256), digit starts (256), the
// scans' totals and the block's counts (16), run starts (kTile + 1), the
// weights (3 rows) and g (stage rows), rows of kTile + 1.
inline size_t bwd_tile_words(int stage) {
  return (size_t)(5 * kTile) + kBwdWarps * 256 + 256 + 16 + 1 +
         (size_t)(3 + stage) * (kTile + 1);
}

// *p where ok, else `off`, as a predicated load: no branch, so a thread's
// loads stay in flight together (the inputs are read-only in the kernel).
__device__ __forceinline__ float ld_if(const float* p, bool ok) {
  float v;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}"
      : "=f"(v) : "l"(p), "r"((int)ok));
  return v;
}

__device__ __forceinline__ long long ld_if(const long long* p, bool ok,
                                           long long off) {
  long long v;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b64 %0, %3;\n"
      " @q ld.global.nc.s64 %0, [%1];\n}"
      : "=l"(v) : "l"(p), "r"((int)ok), "l"(off));
  return v;
}

// Three blocks fit an SM's shared memory, so the registers are held to
// three blocks too.  (Tiles of 2048 columns, one block an SM, took 0.35
// against 0.22 ms at the cow's staged shapes on an H100.)
__global__ void __launch_bounds__(kBwdThreads, 3)
bwd_tile_kernel(const float* __restrict__ table,
                const long long* __restrict__ idx,
                const float* __restrict__ w0, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ g,
                float* __restrict__ dw, float* __restrict__ part,
                int* __restrict__ part_face, int* __restrict__ tile_rows,
                int* __restrict__ face_count, long long p_total, int f,
                int d, int stage, int passes) {
  constexpr int kWarpCols = 32 * kTileItems;
  extern __shared__ __align__(16) int sm[];
  int* s_key = sm;                               // [2][kTile]
  int* s_item = sm + 2 * kTile;                  // [2][kTile]
  int* s_wc = sm + 4 * kTile;                    // [kBwdWarps][256]
  int* s_start = s_wc + kBwdWarps * 256;         // [256]
  int* s_tot = s_start + 256;                    // [8] scans, [8..] counts
  int* s_run = s_tot + 16;                       // [kTile + 1]
  // The weights and g by slot, rows of kTile + 1: a run's components,
  // read by neighbouring threads at one slot, fall in distinct banks.
  constexpr int SW = kTile + 1;
  float* s_w = (float*)(s_run + kTile + 1);      // [3][SW]
  float* s_g = s_w + 3 * SW;                     // [stage][SW]
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long tile = blockIdx.x, base = tile * kTile;
  const bool table_out = part != nullptr;

  // Columns: warp wp owns [wp kWarpCols, (wp + 1) kWarpCols) of the tile,
  // item j at wp kWarpCols + 32 j + lane; the filled ones get consecutive
  // slots in column order.
  int key[kTileItems], slot[kTileItems];
  long long col[kTileItems];
  float wv[kTileItems][3];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    col[j] = base + wp * kWarpCols + 32 * j + lane;
    const long long v = ld_if(idx + col[j], col[j] < p_total, -1);
    key[j] = v >= 0 && v < f ? (int)v : -1;
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const bool ok = key[j] >= 0;
    wv[j][0] = ld_if(w0 + col[j], ok);
    wv[j][1] = ld_if(w1 + col[j], ok);
    wv[j][2] = ld_if(w2 + col[j], ok);
    mine += __popc(__ballot_sync(0xffffffffu, ok));
  }
  if (lane == 0) s_tot[8 + wp] = mine;
  __syncthreads();
  int o = 0, n = 0;
  for (int v = 0; v < kBwdWarps; ++v) {
    o += v < wp ? s_tot[8 + v] : 0;
    n += s_tot[8 + v];
  }
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const unsigned bal = __ballot_sync(0xffffffffu, key[j] >= 0);
    slot[j] = key[j] >= 0 ? o + __popc(bal & lt) : -1;
    if (slot[j] >= 0) {
      s_key[slot[j]] = key[j];
      s_item[slot[j]] = slot[j];
      s_w[slot[j]] = wv[j][0];
      s_w[SW + slot[j]] = wv[j][1];
      s_w[2 * SW + slot[j]] = wv[j][2];
    }
    o += __popc(bal);
  }
  __syncthreads();

  // A tile without a filled column: dw is 0, no partial row.
  if (n == 0) {
    if (t == 0 && table_out) tile_rows[tile] = 0;
    if (dw == nullptr) return;
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      const long long e = col[j];
      if (e >= p_total) continue;
      dw[e] = 0.0f;
      dw[p_total + e] = 0.0f;
      dw[2 * p_total + e] = 0.0f;
    }
    return;
  }

  // The filled columns sorted by face, stably: LSD passes of 8-bit digits.
  int src = 0;
  for (int q = 0; q < passes; ++q) {
    const int shift = 8 * q;
    for (int i = t; i < kBwdWarps * 256; i += kBwdThreads) s_wc[i] = 0;
    __syncthreads();
    const int per = (n + 32 * kBwdWarps - 1) / (32 * kBwdWarps) * 32;
    const int begin = wp * per, end = min(n, begin + per);
    int rank[kTileItems], dig[kTileItems];
#pragma unroll
    for (int r = 0; r < kTileItems; ++r) {
      const int e = begin + 32 * r + lane;
      const bool ok = 32 * r < per && e < end;
      const int dg = ok ? (s_key[src * kTile + e] >> shift) & 255 : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, dg);
      const int before = __popc(peers & lt);
      const int seen = ok ? s_wc[wp * 256 + dg] : 0;
      __syncwarp();
      if (ok && before == 0) s_wc[wp * 256 + dg] = seen + __popc(peers);
      __syncwarp();
      rank[r] = ok ? seen + before : -1;
      dig[r] = dg;
    }
    __syncthreads();
    int run = 0;                     // thread t owns digit t
    for (int v = 0; v < kBwdWarps; ++v) {
      const int c = s_wc[v * 256 + t];
      s_wc[v * 256 + t] = run;
      run += c;
    }
    s_start[t] = ptseg::block_scan256(run, s_tot) - run;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kTileItems; ++r) {
      if (rank[r] < 0) continue;
      const int e = begin + 32 * r + lane;
      const int at = s_start[dig[r]] + s_wc[wp * 256 + dig[r]] + rank[r];
      s_key[(1 - src) * kTile + at] = s_key[src * kTile + e];
      s_item[(1 - src) * kTile + at] = s_item[src * kTile + e];
    }
    __syncthreads();
    src ^= 1;
  }
  const int* keys = s_key + src * kTile;
  const int* items = s_item + src * kTile;
  // dw by slot, in the buffers the sort no longer needs.
  float* const s_dw0 = (float*)(s_key + (1 - src) * kTile);
  float* const s_dw1 = (float*)(s_item + (1 - src) * kTile);
  float* const s_dw2 = (float*)s_wc;

  // Runs of equal faces: thread t's sorted positions [t kTileItems, ...).
  int c = 0;
#pragma unroll
  for (int m = 0; m < kTileItems; ++m) {
    const int i = t * kTileItems + m;
    c += i < n && (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
  }
  int at = ptseg::block_scan256(c, s_tot) - c;
#pragma unroll
  for (int m = 0; m < kTileItems; ++m) {
    const int i = t * kTileItems + m;
    if (i < n && (i == 0 || keys[i] != keys[i - 1])) s_run[at++] = i;
  }
  if (t == kBwdThreads - 1) {
    s_run[at] = n;
    s_tot[15] = at;
  }
  __syncthreads();
  const int nr = s_tot[15];
  if (table_out) {
    if (t == 0) tile_rows[tile] = nr;
    for (int k = t; k < nr; k += kBwdThreads) {
      const int fk = keys[s_run[k]];
      part_face[base + k] = fk;
      atomicAdd(&face_count[fk], 1);
    }
  }

  // Channels in chunks of `stage`: g of the filled columns staged, all
  // loads in flight at once; then per run its partials (3 x the chunk's
  // channels, each in column order) and its columns' dw (per weight, the
  // face's table row once, the channels in order).
  const int width = 3 * d;
  for (int j0 = 0; j0 < d; j0 += stage) {
    const int dc = min(stage, d - j0);
    float gv[kTileItems][kStage];
#pragma unroll
    for (int j = 0; j < kTileItems; ++j)
#pragma unroll
      for (int cc = 0; cc < kStage; ++cc)
        gv[j][cc] = ld_if(g + (long long)(j0 + cc) * p_total + col[j],
                          slot[j] >= 0 && cc < dc);
    __syncthreads();               // the previous chunk's sums are done
#pragma unroll
    for (int j = 0; j < kTileItems; ++j)
#pragma unroll
      for (int cc = 0; cc < kStage; ++cc)
        if (slot[j] >= 0 && cc < dc) s_g[cc * SW + slot[j]] = gv[j][cc];
    __syncthreads();
    // A thread per run: its partials (3 x the chunk's channels, each a sum
    // over the run's columns in column order) and its columns' dw (per
    // weight, the channels in order, from the face's table row).
    for (int r = t; r < nr; r += kBwdThreads) {
      const float* row = table + (long long)keys[s_run[r]] * width + j0;
      float tv[3][kStage], sum[3][kStage];
#pragma unroll
      for (int v = 0; v < 3; ++v)
#pragma unroll
        for (int cc = 0; cc < kStage; ++cc) {
          tv[v][cc] = ld_if(row + v * d + cc, dw != nullptr && cc < dc);
          sum[v][cc] = 0.0f;
        }
      for (int i = s_run[r]; i < s_run[r + 1]; ++i) {
        const int e = items[i];
        float gg[kStage], ww[3];
#pragma unroll
        for (int cc = 0; cc < kStage; ++cc)
          gg[cc] = cc < dc ? s_g[cc * SW + e] : 0.0f;
#pragma unroll
        for (int v = 0; v < 3; ++v) ww[v] = s_w[v * SW + e];
#pragma unroll
        for (int v = 0; v < 3; ++v)
#pragma unroll
          for (int cc = 0; cc < kStage; ++cc)
            if (cc < dc) sum[v][cc] += gg[cc] * ww[v];
        if (dw == nullptr) continue;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          float* out = v == 0 ? s_dw0 : (v == 1 ? s_dw1 : s_dw2);
          float acc = j0 == 0 ? 0.0f : out[e];
#pragma unroll
          for (int cc = 0; cc < kStage; ++cc)
            if (cc < dc) acc += tv[v][cc] * gg[cc];
          out[e] = acc;
        }
      }
      if (!table_out) continue;
      float* prow = part + (base + r) * width + j0;
#pragma unroll
      for (int v = 0; v < 3; ++v)
#pragma unroll
        for (int cc = 0; cc < kStage; ++cc)
          if (cc < dc) prow[v * d + cc] = sum[v][cc];
    }
  }
  if (dw == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const long long e = col[j];
    if (e >= p_total) continue;
    const bool ok = slot[j] >= 0;
    dw[e] = ok ? s_dw0[slot[j]] : 0.0f;
    dw[p_total + e] = ok ? s_dw1[slot[j]] : 0.0f;
    dw[2 * p_total + e] = ok ? s_dw2[slot[j]] : 0.0f;
  }
}

// The faces' starts in the list (exclusive scan of face_count), into
// face_start and face_next; one block of 1024 threads, 1024 faces at a
// time.  (A thread summing 8 consecutive faces took 0.030 against 0.019
// ms at the cow's 20,480 faces on an H100.)
__global__ void __launch_bounds__(1024)
face_scan_kernel(const int* __restrict__ face_count,
                 int* __restrict__ face_start, int* __restrict__ face_next,
                 int f) {
  __shared__ int s_w[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int carry = 0;
  for (int b0 = 0; b0 < f; b0 += 1024) {
    const int i = b0 + threadIdx.x;
    const int c = i < f ? face_count[i] : 0;
    int inc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane == 31) s_w[w] = inc;
    __syncthreads();
    if (w == 0) {
      int x = s_w[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += u;
      }
      s_w[lane] = x;
    }
    __syncthreads();
    const int start = carry + (w > 0 ? s_w[w - 1] : 0) + inc - c;
    if (i < f) {
      face_start[i] = start;
      face_next[i] = start;
    }
    carry += s_w[31];
    __syncthreads();
  }
}

// Each partial row's id into its face's part of the list; a block per
// tile.
__global__ void __launch_bounds__(kBwdThreads)
face_fill_kernel(const int* __restrict__ tile_rows,
                 const int* __restrict__ part_face,
                 int* __restrict__ face_next, int* __restrict__ list,
                 int tile) {
  const long long base = (long long)blockIdx.x * tile;
  const int nr = tile_rows[blockIdx.x];
  for (int r = threadIdx.x; r < nr; r += kBwdThreads)
    list[atomicAdd(&face_next[part_face[base + r]], 1)] = (int)(base + r);
}

// A warp per face: its row ids sorted (ranks by comparison, every id
// against every other, 32 at a time by shuffles) into `sorted`, then its
// partials added in that order, a lane per component.
__global__ void __launch_bounds__(256)
face_merge_kernel(const float* __restrict__ part,
                  const int* __restrict__ face_count,
                  const int* __restrict__ face_start,
                  const int* __restrict__ list, int* __restrict__ sorted,
                  float* __restrict__ d_table, int f, int width) {
  const long long face =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (face >= f) return;            // uniform across the warp
  const int n = face_count[face], s = face_start[face];
  for (int ka = 0; ka < n; ka += 32) {
    const int mine = ka + lane < n ? list[s + ka + lane] : INT_MAX;
    int rank = 0;
    for (int kb = 0; kb < n; kb += 32) {
      const int other = kb + lane < n ? list[s + kb + lane] : INT_MAX;
      for (int l = 0; l < 32; ++l)
        rank += __shfl_sync(0xffffffffu, other, l) < mine ? 1 : 0;
    }
    if (ka + lane < n) sorted[s + rank] = mine;
  }
  __syncwarp();
  for (int c = lane; c < width; c += 32) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k)
      acc += part[(long long)sorted[s + k] * width + c];
    d_table[face * width + c] = acc;
  }
}

}  // namespace

extern "C" int pt_interp_rows(const void* table, const void* idx,
                              const void* w0, const void* w1, const void* w2,
                              void* out, long long p, int f, int d,
                              void* stream) {
  if (p == 0) return 0;
  const int threads = 256;
  interp_fwd_kernel<<<(unsigned)((p + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)table, (const long long*)idx, (const float*)w0,
      (const float*)w1, (const float*)w2, (float*)out, p, f, d);
  return (int)cudaGetLastError();
}

// K10b; `tile` must be kTile (the wrapper's BWD_TILE).  dw (3, P) or null
// (no weight gradient); d_table (F, 3, D) or null (no table gradient),
// then its workspace: part (tiles x kTile rows of 3D floats), part_face,
// list and sorted (tiles x kTile ints each), tile_rows (tiles ints),
// face_count (F ints, zero on entry), face_start and face_next (F ints
// each).
extern "C" int pt_interp_rows_bwd(
    const void* table, const void* idx, const void* w0, const void* w1,
    const void* w2, const void* g, void* dw, void* d_table, void* part,
    void* part_face, void* list, void* sorted, void* tile_rows,
    void* face_count, void* face_start, void* face_next, long long p, int f,
    int d, int tile, void* stream) {
  if (tile != kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (p + tile - 1) / tile;
  const bool table_out = d_table != nullptr;
  if (tiles > 0) {
    const int stage = d < kStage ? d : kStage;
    const size_t smem = sizeof(int) * bwd_tile_words(stage);
    cudaError_t e = cudaFuncSetAttribute(
        bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    bwd_tile_kernel<<<(unsigned)tiles, kBwdThreads, smem, st>>>(
        (const float*)table, (const long long*)idx, (const float*)w0,
        (const float*)w1, (const float*)w2, (const float*)g, (float*)dw,
        table_out ? (float*)part : nullptr, (int*)part_face,
        (int*)tile_rows, (int*)face_count, p, f, d, stage,
        ptseg::sort_passes(f));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (!table_out) return 0;
  face_scan_kernel<<<1, 1024, 0, st>>>((const int*)face_count,
                                       (int*)face_start, (int*)face_next, f);
  if (tiles > 0)
    face_fill_kernel<<<(unsigned)tiles, kBwdThreads, 0, st>>>(
        (const int*)tile_rows, (const int*)part_face, (int*)face_next,
        (int*)list, tile);
  const long long warps_per_block = 256 / 32;
  face_merge_kernel<<<(unsigned)((f + warps_per_block - 1) /
                                 warps_per_block),
                      256, 0, st>>>(
      (const float*)part, (const int*)face_count, (const int*)face_start,
      (const int*)list, (int*)sorted, (float*)d_table, f, 3 * d);
  return (int)cudaGetLastError();
}
