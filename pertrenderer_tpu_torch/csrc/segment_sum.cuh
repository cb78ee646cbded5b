// Deterministic segment sums: the index preparation and the reduction
// of K9b (csrc/gather.cu).  The weighted form was K10b's table gradient
// until K10b's tile pass (csrc/interp_gather.cu) replaced it; it stays so
// that K9b's kernels keep their arguments and machine code.
//
// out[r, v, j] = sum over the columns p with idx[p] = r of
// g[j, p] (* w_v[p] when weighted), for rows r < rows, channels j < d and
// v < 3 weights (one when unweighted), in ascending p, without float
// atomics: repeated launches give the same bits.
//
// Preparation (`prepare`), all on the card (ops/gather.py `segments`):
//  1. compact_kernel: one read of idx; each block takes the next tile of
//     4096 columns and keeps the valid ones (0 <= idx < rows) in order as
//     int32 keys and column positions (warp ballots; the earlier tiles'
//     counts by a decoupled look-back that one warp takes 32 tiles at a
//     time).
//  2. Per 8-bit digit of the ceil(log2(rows)) key bits (2 for the cow's
//     20,480 rows, 3 for config 5's 81,920), a stable LSD pass of three
//     kernels over tiles of 4096 keys: digit_count_kernel (each tile's 256
//     digit counts, digit-major), digit_scan_kernel (a block per digit:
//     the exclusive prefix over the tiles and the digit's total; no chain
//     between tiles) and digit_scatter_kernel (the digits' buckets from
//     the totals; stable ranks within the tile, 32 keys at a time by
//     __match_any_sync peers and per-warp digit counts in shared memory;
//     the keys staged in shared memory in digit order so that each
//     digit's keys leave the tile as one contiguous run).  The result is the order
//     torch.sort(key, stable=True) gives (ascending p within a row).
//  3. bounds_kernel: each row's [start, end) from the boundaries of the
//     sorted keys (one thread per sorted column, no search; absent rows
//     stay [0, 0)), then chunks_kernel: the chunk -> row table.  Row r's
//     columns are cut into chunks of kChunk from its start; chunk j of
//     row r has the id start_r / kChunk + r + j, which is increasing in
//     (r, j) and below ceil(P / kChunk) + rows (see ops/gather.py); the
//     table holds r + 1 there and 0 at the ids no chunk takes.
//
// Sum: sum_kernel, one warp per chunk; its row from the table; each lane
// loads its (at most 8) strided positions once, then for every weight and
// channel adds its columns in ascending order, and a fixed xor butterfly
// sums the lanes into the chunk's partial row.  final_kernel: one thread
// per output element adds its row's chunk partials in ascending order; a
// row without columns is an exact 0.
//
// Bound: bytes.  idx is read once, the compacted keys and positions once
// per pass and twice more (bounds, chunks),
// g and the weights at the valid columns once (scattered reads: each
// value costs a 32-byte sector unless a neighbour shares it in L2).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptseg {

constexpr int kChunk = 256;            // sorted columns per chunk
constexpr int kSortThreads = 256;      // threads per radix tile
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;         // keys per thread
constexpr int kTile = kSortThreads * kSortItems;
constexpr int kWarpKeys = 32 * kSortItems;
constexpr int kValid = 256;            // counts[]: the valid columns' number

namespace {

// Key bits of rows in [0, rows): the least b with 2^b >= rows.
inline int key_bits(int rows) {
  int b = 0;
  while ((1ll << b) < rows) ++b;
  return b;
}

inline int sort_passes(int rows) {
  const int b = key_bits(rows);
  return b <= 8 ? 1 : (b + 7) / 8;
}

inline long long sort_tiles(long long p) { return (p + kTile - 1) / kTile; }

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* a) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* a,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(a), "l"(v) : "memory");
}

// Inclusive scan of v over a block of 256 threads: warp shuffles, then
// the warps' totals (s_tot: 8 ints of shared memory).
__device__ __forceinline__ int block_scan256(int v, int* s_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) s_tot[w] = v;
  __syncthreads();
  for (int i = 0; i < w; ++i) v += s_tot[i];
  __syncthreads();
  return v;
}

// The exclusive prefix of `count` over the tiles before `tile` by a
// decoupled look-back on status words (one per tile; the flag in the high
// half: 1 a tile's own count, 2 its inclusive prefix; zero before
// publication), taken by one whole warp: lane l reads tile - 1 - l of the
// next 32, and the warp stops at the nearest inclusive prefix.  Returns
// the prefix in every lane.
__device__ __forceinline__ unsigned long long warp_look_back(
    unsigned long long* status, long long tile, unsigned count) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    st_relaxed(status + tile, ((tile == 0 ? 2ull : 1ull) << 32) | count);
  unsigned long long excl = 0;
  for (long long j = tile - 1; j >= 0; j -= 32) {
    const long long jj = j - lane;
    unsigned long long v = jj >= 0 ? ld_relaxed(status + jj) : (2ull << 32);
    while ((v >> 32) == 0) v = ld_relaxed(status + jj);
    const unsigned incl = __ballot_sync(0xffffffffu, (v >> 32) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long part = lane <= stop ? (v & 0xffffffffull) : 0ull;
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    excl += part;
    if (incl) break;
  }
  if (lane == 0 && tile > 0)
    st_relaxed(status + tile, (2ull << 32) | (unsigned)(excl + count));
  return excl;
}

// The valid columns in order as (key, position); counts[kValid] gets
// their number.  status: one look-back word per tile; tile_counter
// zero on entry.
__global__ void __launch_bounds__(kSortThreads)
compact_kernel(const long long* __restrict__ idx, long long p_total,
               int rows, int* __restrict__ counts,
               unsigned long long* __restrict__ status, int* tile_counter,
               int* __restrict__ keys_out, int* __restrict__ pos_out) {
  __shared__ int s_warp[kSortWarps];
  __shared__ int s_tile, s_excl;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const long long base = (long long)s_tile * kTile;
  if (base >= p_total) return;              // uniform: no later tile waits
  const unsigned lt = (1u << lane) - 1u;
  int key[kSortItems];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const long long e = base + (long long)w * kWarpKeys + j * 32 + lane;
    const long long v = e < p_total ? idx[e] : -1;
    const bool ok = v >= 0 && v < rows;
    key[j] = ok ? (int)v : -1;
    mine += __popc(__ballot_sync(0xffffffffu, ok));
  }
  if (lane == 0) s_warp[w] = mine;
  __syncthreads();
  if (w == 0) {
    int c = lane < kSortWarps ? s_warp[lane] : 0, run = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run += u;
    }
    const int total = __shfl_sync(0xffffffffu, run, 31);
    if (lane < kSortWarps) s_warp[lane] = run - c;
    const unsigned long long excl =
        warp_look_back(status, s_tile, (unsigned)total);
    if (lane == 0) {
      s_excl = (int)excl;
      if (total) atomicAdd(&counts[kValid], total);
    }
  }
  __syncthreads();
  int o = s_excl + s_warp[w];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const bool ok = key[j] >= 0;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const int at = o + __popc(bal & lt);
      keys_out[at] = key[j];
      pos_out[at] = (int)(base + (long long)w * kWarpKeys + j * 32 + lane);
    }
    o += __popc(bal);
  }
}

// Each tile's 256 digit counts of its keys, digit-major: tcount[d * tiles
// + tile] (zero for tiles past the keys).
__global__ void __launch_bounds__(kSortThreads)
digit_count_kernel(const int* __restrict__ keys,
                   const int* __restrict__ counts, int* __restrict__ tcount,
                   long long tiles, int shift) {
  __shared__ int s_hist[256];
  const int t = threadIdx.x;
  const long long tile = blockIdx.x;
  s_hist[t] = 0;
  __syncthreads();
  const long long n = counts[kValid];
  const long long base = tile * kTile;
  for (int i = t; i < kTile; i += kSortThreads) {
    const long long e = base + i;
    if (e < n) atomicAdd(&s_hist[(keys[e] >> shift) & 255], 1);
  }
  __syncthreads();
  tcount[(long long)t * tiles + tile] = s_hist[t];
}

// Exclusive prefix of each digit's tile counts over the tiles that hold
// keys, in place (block d takes digit d's row), and the digit's total
// into dtotal[d].
__global__ void __launch_bounds__(1024)
digit_scan_kernel(int* __restrict__ tcount, const int* __restrict__ counts,
                  long long tiles, int* __restrict__ dtotal) {
  __shared__ int s_w[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long n = counts[kValid];
  const long long nt = (n + kTile - 1) / kTile;
  int* row = tcount + (long long)blockIdx.x * tiles;
  int carry = 0;
  for (long long t0 = 0; t0 < nt; t0 += 1024) {
    const long long tt = t0 + threadIdx.x;
    const int c = tt < nt ? row[tt] : 0;
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
    const int before = w > 0 ? s_w[w - 1] : 0;
    if (tt < nt) row[tt] = carry + before + inc - c;
    carry += s_w[31];
    __syncthreads();
  }
  if (threadIdx.x == 0) dtotal[blockIdx.x] = carry;
}

// The scatter of one stable LSD pass over the digit (key >> shift) & 255:
// tile `blockIdx.x`'s keys to the digit's bucket (the exclusive scan of
// dtotal) + toff[d * tiles + tile] + their stable rank among the tile's
// keys of digit d.
__global__ void __launch_bounds__(kSortThreads)
digit_scatter_kernel(const int* __restrict__ keys_in,
                     const int* __restrict__ pos_in,
                     int* __restrict__ keys_out, int* __restrict__ pos_out,
                     const int* __restrict__ counts,
                     const int* __restrict__ toff,
                     const int* __restrict__ dtotal, long long tiles,
                     int shift) {
  __shared__ int s_warp[kSortWarps][256];   // per-warp counts, then prefixes
  __shared__ int s_start[256];              // the digits' starts in the tile
  __shared__ int s_key[kTile], s_pos[kTile];
  __shared__ int s_tot[kSortWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long tile = blockIdx.x;
  const long long n = counts[kValid];
  const long long base = tile * kTile;
  if (base >= n) return;                    // uniform over the block
  for (int i = t; i < kSortWarps * 256; i += kSortThreads)
    (&s_warp[0][0])[i] = 0;
  const int dt = dtotal[t];
  const int bucket = block_scan256(dt, s_tot) - dt;
  // Stable ranks within the warp's 512 keys, 32 at a time.
  int key[kSortItems], pos[kSortItems], rank[kSortItems];
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const long long e = base + (long long)w * kWarpKeys + j * 32 + lane;
    const bool ok = e < n;
    const int k = ok ? keys_in[e] : 0;
    const int ps = ok ? pos_in[e] : 0;
    const int d = (k >> shift) & 255;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? d : -1);
    const int before = __popc(peers & lt);
    const int seen = ok ? s_warp[w][d] : 0;
    __syncwarp();
    if (ok && before == 0) s_warp[w][d] = seen + __popc(peers);
    __syncwarp();
    key[j] = k;
    pos[j] = ps;
    rank[j] = ok ? seen + before : -1;
  }
  __syncthreads();
  // Thread t owns digit t: the warps' prefixes and the tile's count.
  int run = 0;
  for (int v = 0; v < kSortWarps; ++v) {
    const int cnt = s_warp[v][t];
    s_warp[v][t] = run;
    run += cnt;
  }
  const int off = bucket + toff[(long long)t * tiles + tile];
  const int incl = block_scan256(run, s_tot);
  s_start[t] = incl - run;
  if (t == kSortThreads - 1) s_tot[0] = incl;
  __syncthreads();
  const int tile_keys = s_tot[0];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (rank[j] < 0) continue;
    const int d = (key[j] >> shift) & 255;
    const int o = s_start[d] + s_warp[w][d] + rank[j];
    s_key[o] = key[j];
    s_pos[o] = pos[j];
  }
  // s_off: each digit's offset in the output, for the staged keys.
  __shared__ int s_off[256];
  s_off[t] = off;
  __syncthreads();
  for (int i = t; i < tile_keys; i += kSortThreads) {
    const int k = s_key[i], d = (k >> shift) & 255;
    const int o = s_off[d] + i - s_start[d];
    keys_out[o] = k;
    pos_out[o] = s_pos[i];
  }
}

// Each row's [start, end) in the sorted keys, from their boundaries.
__global__ void bounds_kernel(const int* __restrict__ keys,
                              const int* __restrict__ counts,
                              int* __restrict__ starts,
                              int* __restrict__ ends) {
  const long long n = counts[kValid];
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    const int k = keys[o];
    if (o == 0 || keys[o - 1] != k) starts[k] = (int)o;
    if (o == n - 1 || keys[o + 1] != k) ends[k] = (int)(o + 1);
  }
}

// chunk_row[start_r / kChunk + r + j] = r + 1 for chunk j of every row r.
__global__ void chunks_kernel(const int* __restrict__ keys,
                              const int* __restrict__ counts,
                              const int* __restrict__ starts,
                              int* __restrict__ chunk_row) {
  const long long n = counts[kValid];
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    const int k = keys[o];
    const int s = starts[k];
    const long long off = o - s;
    if (off % kChunk == 0)
      chunk_row[(long long)(s / kChunk) + k + off / kChunk] = k + 1;
  }
}

template <bool kWeighted>
__global__ void __launch_bounds__(256)
sum_kernel(const float* __restrict__ g, const float* __restrict__ w0,
           const float* __restrict__ w1, const float* __restrict__ w2,
           const int* __restrict__ order, const int* __restrict__ starts,
           const int* __restrict__ ends, const int* __restrict__ chunk_row,
           float* __restrict__ partial, long long p_total, int d,
           long long n_chunks) {
  constexpr int kPer = kChunk / 32;
  const long long c =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // c is uniform across a warp, so whole warps leave together.
  if (c >= n_chunks) return;
  const int r = chunk_row[c] - 1;
  if (r < 0) return;
  const int s = starts[r];
  const long long begin =
      s + (c - (long long)(s / kChunk) - r) * kChunk;
  const long long end = begin + kChunk < ends[r] ? begin + kChunk : ends[r];
  int pos[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long at = begin + lane + 32 * i;
    pos[i] = at < end ? order[at] : -1;
  }
  const int nv = kWeighted ? 3 : 1;
  float* out = partial + c * (long long)(nv * d);
  for (int v = 0; v < nv; ++v) {
    float wv[kPer];
    if (kWeighted) {
      const float* w = v == 0 ? w0 : (v == 1 ? w1 : w2);
#pragma unroll
      for (int i = 0; i < kPer; ++i) wv[i] = pos[i] >= 0 ? __ldg(w + pos[i])
                                                         : 0.0f;
    }
    for (int j = 0; j < d; ++j) {
      const float* gj = g + (long long)j * p_total;
      float x[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        x[i] = pos[i] >= 0 ? __ldg(gj + pos[i]) : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (pos[i] < 0) break;
        acc += kWeighted ? x[i] * wv[i] : x[i];
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out[v * d + j] = acc;
    }
  }
}

__global__ void final_kernel(const float* __restrict__ partial,
                             const int* __restrict__ starts,
                             const int* __restrict__ ends,
                             float* __restrict__ out, int rows, int width) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * width) return;
  const int r = (int)(i / width), j = (int)(i % width);
  const int s = starts[r], e = ends[r];
  const long long c0 = (long long)(s / kChunk) + r;
  const long long nc = (e - s + kChunk - 1) / kChunk;
  float acc = 0.0f;
  for (long long c = c0; c < c0 + nc; ++c) acc += partial[c * width + j];
  out[i] = acc;
}

inline unsigned grid_for(long long work, int threads, long long cap) {
  long long b = (work + threads - 1) / threads;
  if (b > cap) b = cap;
  return (unsigned)(b < 1 ? 1 : b);
}

// The workspace of `prepare`, laid out by the caller (ops/gather.py) and
// zero on entry: status (sort_tiles(p) look-back words), counts (each
// pass's 256 digit totals, the valid count at kValid, the compaction's
// tile counter after it), tcount (256 * sort_tiles(p) ints,
// any contents), starts / ends (rows ints each)
// and chunk_row (n_chunks ints).  The sorted keys and positions end in
// (keys_a, pos_a) after an even number of passes, else in (keys_b,
// pos_b).
inline int prepare(const long long* idx, long long p_total, int rows,
                   int* counts, unsigned long long* status, int* tcount,
                   int* keys_a, int* pos_a, int* keys_b, int* pos_b,
                   int* starts, int* ends, int* chunk_row,
                   cudaStream_t stream) {
  const int passes = sort_passes(rows);
  const long long tiles = sort_tiles(p_total);
  compact_kernel<<<(unsigned)tiles, kSortThreads, 0, stream>>>(
      idx, p_total, rows, counts, status, counts + kValid + 1,
      keys_a, pos_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int *kin = keys_a, *pin = pos_a, *kout = keys_b, *pout = pos_b;
  for (int q = 0; q < passes; ++q) {
    digit_count_kernel<<<(unsigned)tiles, kSortThreads, 0, stream>>>(
        kin, counts, tcount, tiles, 8 * q);
    digit_scan_kernel<<<256, 1024, 0, stream>>>(tcount, counts, tiles,
                                                counts);
    digit_scatter_kernel<<<(unsigned)tiles, kSortThreads, 0, stream>>>(
        kin, pin, kout, pout, counts, tcount, counts, tiles, 8 * q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int* tk = kin;
    int* tp = pin;
    kin = kout;
    pin = pout;
    kout = tk;
    pout = tp;
  }
  const unsigned grid = grid_for(p_total, 256, 132 * 16);
  bounds_kernel<<<grid, 256, 0, stream>>>(kin, counts, starts, ends);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunks_kernel<<<grid, 256, 0, stream>>>(kin, counts, starts, chunk_row);
  return (int)cudaGetLastError();
}

// Both passes of the sum on `stream`; returns the first launch error (0 if
// none).
template <bool kWeighted>
inline int segment_sum(const float* g, const float* w0, const float* w1,
                       const float* w2, const int* order, const int* starts,
                       const int* ends, const int* chunk_row, float* partial,
                       float* out, long long p_total, int rows, int d,
                       long long n_chunks, cudaStream_t stream) {
  const int threads = 256;
  const long long warps_per_block = threads / 32;
  if (n_chunks > 0) {
    const long long blocks = (n_chunks + warps_per_block - 1) /
                             warps_per_block;
    sum_kernel<kWeighted><<<(unsigned)blocks, threads, 0, stream>>>(
        g, w0, w1, w2, order, starts, ends, chunk_row, partial, p_total, d,
        n_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int width = (kWeighted ? 3 : 1) * d;
  const long long total = (long long)rows * width;
  if (total > 0) {
    final_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   stream>>>(partial, starts, ends, out, rows, width);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ptseg
