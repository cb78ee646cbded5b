// K6 / K7's gradient pipeline (stream_backward.cu, stream_loss_grad.cu):
// the stream route's two sweeps with a chunk's rows across the lanes of a
// warp, as the JAX kernels' _stream_grad_impl
// (pertrenderer_tpu/ops/fused_render.py:2283); and K5's forward
// (stream_forward.cu: warp_forward_chunk, B1's layout without the
// gradients' state, below).
//
// Work: a block takes 32 pixels of one JAX stream tile (a pixel row of an
// 8 x 32 tile, a quarter of a 128-pixel strip), so a tile is p_tile / 32
// blocks and the tile's chunk list is walked by each.  The tiles and their
// lists stay JAX's: they decide which rows' noise enters phi and nreal.
// Each warp renders its pixels in turn, one pixel at a time with the
// chunk's rows across its lanes: lane h owns rows h and h + 32, exactly
// the cos and sin halves of hash(row_base + h), so each hash is made once
// and both halves are used (pair_rows, stream_grad.cuh); det1, coverage,
// z_map and the rows' adjoints sit in the lane's registers.
//
// A pixel's state between chunks and from B1 to B2 is a record (Rec): the
// alpha product and its exclusion track, the online softmax, the control
// variate, and per aggregation sample the running max, winner row and
// colour, phi and, after B1, dot; in shared memory during a sweep, in
// device memory from one kernel to the next.  Lane l keeps the samples l,
// l + 32 of the record.  Rows that are not candidates are not shaded
// (their colour is 0 either way).
//
// B1 (warp_chunk_forward) replays the forward and renders K5's image bit
// for bit: alpha's product in prod_rows' halving order (q[h] q[h + 32] in
// the lane, then shuffles down by 16, 8, 4, 2, 1); per sample a ballot of
// the rows strictly above the running max (most chunks have none), and
// only then the chunk's winner as a warp max and the lowest row reaching
// it (a ballot of the cos halves, then of the sin halves), so every winner
// keeps the per-row scan's bits; the softmax's sums in K5's row order
// through a per-warp scratch; phi a warp sum per sample over every row.
// warp_post (lane 0) fixes the pixel's cotangents.  B2 (warp_chunk_grads)
// runs the adjoints of the aggregation, z_map (no stabilising shift, no
// clamp), coverage and det1 for the lane's candidate rows; alpha's
// cotangent uses the exact exclusion products from zcnt (the count of
// prob >= 1) and pnz, never ap / (1 - p).
//
// Row gradients: each warp adds its rows, pixel after pixel, into its own
// slice of shared memory (a row belongs to one lane, so no two lanes
// write one address, and no atomics); behind one barrier per chunk visit
// the block adds the slices in warp order into the visit's partial rows,
// only the rows that had a candidate (a 64-bit mask per visit and block).
// A second kernel adds each chunk's partial rows over its visits in
// ascending tile order and the tile's blocks in order.  Scalars: float per
// lane over a visit, then a warp sum in double into the warp's totals;
// the block adds its warps in order, a third kernel the blocks.  So two
// launches give the same bits.
//
// Two kernels, one block for each 32 pixels: stream_replay_kernel runs B1
// and the post step and leaves each pixel's record in device memory;
// stream_adjoint_kernel runs B2.  Apart, B1's blocks need no slices, so
// four of them fit on an SM where B2's fit two.  The chunks reach shared
// memory by bulk copies (TMA, cp.async.bulk) onto mbarriers: B1
// double-buffers them, B2 copies the next chunk while the block adds the
// slices.
#pragma once

#include "stream_grad.cuh"
#include "warp.cuh"

namespace ptf {

using namespace ptw;

constexpr int kBlockPix = 32;        // pixels of a tile per block
constexpr int kStreamWarps = 4;      // warps per block, at most

// A pixel's record: the head, then 7 arrays of S floats (S = agg_samples):
// running max, winner row (exact in float below 2^24), winner colour (3),
// phi and dot.  Above kMaxS samples (stream_passes > 1) the record in
// device memory holds every sample and B1's shared memory a window of
// kMaxS: the head and pass k's samples.
enum RecHead {
  kRAlpha = 0, kRZcnt, kRPnz, kRM, kRDen, kRNum, kRRm0 = kRNum + 3, kRW0c,
  kRNreal = kRW0c + 3, kRGrgb, kRGalpha = kRGrgb + 3, kRDotw, kRHead
};

PT_HOST_HD int rec_floats(const Params& p) {
  return kRHead + 7 * agg_samples(p);
}

// A record in shared memory: the whole record in one pass, else a window.
PT_HOST_HD int rec_window_floats(const Params& p) {
  return kRHead + 7 * min(agg_samples(p), kMaxS);
}

// A record's per-sample arrays (each S long; winc 3 of them) hold samples
// s0 .. s0 + ns - 1.
struct Rec {
  float *h, *runmax, *winid, *winc, *phi, *dot;
  int S, s0, ns;
};

PT_HD Rec rec_at(const Params& p, float* base, int S) {
  Rec r;
  r.S = r.ns = S;
  r.s0 = 0;
  r.h = base;
  r.runmax = base + kRHead;
  r.winid = r.runmax + S;
  r.winc = r.winid + S;
  r.phi = r.winc + 3 * S;
  r.dot = r.phi + S;
  return r;
}

PT_HD Rec rec_at(const Params& p, float* base) {
  return rec_at(p, base, agg_samples(p));
}

// Pass k's window of a record in shared memory (kMaxS per-sample slots).
PT_HD Rec rec_window(const Params& p, float* base, int k) {
  Rec r = rec_at(p, base, min(agg_samples(p), kMaxS));
  r.s0 = k * kMaxS;
  r.ns = min(kMaxS, agg_samples(p) - r.s0);
  return r;
}

// MULTI: the kernels run more than one pass (stream_passes > 1).  Pass
// k's record in shared memory at `base`: without MULTI the whole record,
// else its window.
template <bool MULTI>
PT_HD Rec rec_pass(const Params& p, float* base, int k) {
  return MULTI ? rec_window(p, base, k) : rec_at(p, base);
}

// A pixel's whole record: without MULTI in shared memory at `base`, else
// in device memory at `drec` with its head in shared memory at `base`.
template <bool MULTI>
PT_HD Rec rec_whole(const Params& p, float* base, float* drec) {
  if (!MULTI) return rec_at(p, base);
  Rec r = rec_at(p, drec);
  r.h = base;
  return r;
}

// The window's samples into the whole record (lanes of warp w).
template <class Wp>
PT_HD void rec_window_out(const Rec& win, const Rec& all, Wp& w) {
  for (int i = w.lane; i < win.ns; i += 32) {
    const int s = win.s0 + i;
    all.runmax[s] = win.runmax[i];
    all.winid[s] = win.winid[i];
    for (int c = 0; c < 3; ++c) all.winc[c * all.S + s] = win.winc[c * win.S + i];
    all.phi[s] = win.phi[i];
  }
}

// A lane's float sums over a visit (face_backward's PixelAcc), folded into
// the warp's double totals (gsc, g_gal, g_invgam, loss).
constexpr int kTot = kNS + 3;

struct StreamAcc {
  double gsc[kNS];
  double g_gal, g_invgam, loss;
};

PT_HD void acc_clear(PixelAcc& a) {
#pragma unroll
  for (int k = 0; k < kNS; ++k) a.gsc[k] = 0.0f;
  a.g_gal = a.g_invgam = a.loss = 0.0f;
}

template <class Wp>
PT_HD void warp_fold(Wp& w, PixelAcc& a, double* tot) {
#pragma unroll
  for (int k = 0; k < kTot; ++k) {
    const float v = k < kNS ? a.gsc[k]
                            : (k == kNS ? a.g_gal
                                        : (k == kNS + 1 ? a.g_invgam : a.loss));
    const double s = wsum(w, (double)v);
    if (w.lane == 0) tot[k] += s;
  }
  acc_clear(a);
}

// The block's scalar sums once every chunk is done: the z_map's
// gamma / alpha factor (gamma's share only for the argmax aggregations:
// the softmax's is in its 1 / gamma term, see warp_chunk_grads), the
// softmax's 1 / gamma, and its znear / zfar from the same sum.
PT_HD void stream_finish(const Params& p, const float* sc, StreamAcc& acc) {
  const double gamma = sc[kGamma], alpha = sc[kAlpha];
  if (p.agg_kind != kAggHard) {
    if (p.agg_kind != kAggSoft) acc.gsc[kGamma] += acc.g_gal / alpha;
    acc.gsc[kAlpha] += -acc.g_gal * gamma / (alpha * alpha);
  }
  acc.gsc[kGamma] += -acc.g_invgam / (gamma * gamma);
  if (p.agg_kind == kAggSoft) {        // G's share (warp_post)
    const double gz_den = gamma * ((double)sc[kZfar] - (double)sc[kZnear]);
    acc.gsc[kZnear] += acc.g_invgam / gz_den;
    acc.gsc[kZfar] += -acc.g_invgam / gz_den;
  }
}

// The pixel's record before the first chunk: the background channel alone
// (the head only for the first of its samples).
template <class Wp>
PT_HD void warp_state_init(const Params& p, const float* sc, int b,
                           uint32_t pos, Wp& w, const Rec& R) {
  if (w.lane == 0 && R.s0 == 0) {
    float* h = R.h;
    h[kRAlpha] = h[kRPnz] = 1.0f;
    h[kRZcnt] = 0.0f;
    for (int c = 0; c < 3; ++c) h[kRNum + c] = h[kRW0c + c] = sc[kBg + c];
    h[kRM] = p.eps_bg * (1.0f / sc[kGamma]);
    h[kRDen] = 1.0f;
    h[kRRm0] = p.eps_bg;
    h[kRNreal] = 0.0f;
  }
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  for (int i = w.lane; i < R.ns; i += 32) {
    R.runmax[i] = bg_start(p, sc, a0, a1, R.s0 + i, pos, &R.phi[i]);
    R.winid[i] = (float)p.rw;
    for (int c = 0; c < 3; ++c) R.winc[c * R.S + i] = sc[kBg + c];
  }
}

// Product of the chunk's 64 q values in prod_rows' halving order: lane h
// holds q[h] and q[h + 32].  Every lane gets it.
template <class Wp>
PT_HD float warp_prod_rows(Wp& w, float lo, float hi) {
  float v = lo * hi;
  for (int half = kHalf / 2; half >= 1; half >>= 1) {
    const float u = w.shfl_down(v, half);
    if (w.lane < half) v = v * u;
  }
  return w.shfl(v, 0);
}

// The chunk's first row reaching the max of (lo, hi) over the lanes (rows
// lane and lane + 32), or -1 when every value is NaN; *mx the max.
template <class Wp>
PT_HD int warp_first_max(Wp& w, float lo, float hi, float* mx) {
  const float m = wmax(w, fmaxf(lo, hi));
  const unsigned bl = w.ballot(lo == m), bh = w.ballot(hi == m);
  *mx = m;
  return bl ? pt_ffs(bl) : (bh ? kHalf + pt_ffs(bh) : -1);
}

// Row r's colour (all lanes; r uniform, r >= 0).
template <class Wp>
PT_HD void warp_row_colour(Wp& w, const PairRows& Q, int r, float col[3]) {
  for (int c = 0; c < 3; ++c)
    col[c] = w.shfl(r >= kHalf ? Q.col[1][c] : Q.col[0][c], r & (kHalf - 1));
}

// The online softmax's step at one chunk (K5, B1): from the running max m
// of x = z_map / gamma, the new max, the old sums' scale and the chunk's
// sums of e = exp(x - m_new) and of e times each colour channel over rows
// 0..63 in order (the per-row walk's order, which keeps its bits): the
// terms go through the warp's scratch of 4 x 64 floats and lanes 0..3
// each add one sum.  Every lane gets the results.
template <class Wp>
PT_HD void warp_softmax_chunk(Wp& w, const PairRows& Q, float gamma, float m,
                              float* scr, float* m_new, float* scale,
                              float sums[4]) {
  const float inv_g = 1.0f / gamma;
  const float x0 = Q.zmap[0] * inv_g, x1 = Q.zmap[1] * inv_g;
  *m_new = fmaxf(m, wmax(w, fmaxf(x0, x1)));
  *scale = expf(m - *m_new);
  for (int k = 0; k < 2; ++k) {
    const int r = w.lane + k * kHalf;
    const float e = expf((k ? x1 : x0) - *m_new);
    scr[r] = e;
    for (int c = 0; c < 3; ++c) scr[(c + 1) * kChunk + r] = e * Q.col[k][c];
  }
  w.sync();
  float sum = 0.0f;
  if (w.lane < 4)
    for (int r = 0; r < kChunk; ++r) sum += scr[w.lane * kChunk + r];
  for (int c = 0; c < 4; ++c) sums[c] = w.shfl(sum, c);
  w.sync();
}

// R's samples at one chunk of B1: phi and the running argmax of each.
template <class Wp>
PT_HD void warp_chunk_samples(const Params& p, const float* sc, int b,
                              int cid, uint32_t pos, Wp& w, const Rec& R,
                              const PairRows& Q) {
  const float gamma = sc[kGamma];
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  const uint32_t base = (uint32_t)(cid * kChunk);
  const bool mc = p.agg_kind == kAggMC;
  for (int i = 0; i < R.ns; ++i) {
    const int s = R.s0 + i;
    float v0 = Q.zmap[0], v1 = Q.zmap[1];
    if (mc) {
      float n0, n1;
      noise_pair(p.agg_noise, a0, a1, s, base, w.lane, pos, &n0, &n1);
      v0 = Q.zmap[0] + gamma * n0;
      v1 = Q.zmap[1] + gamma * n1;
      const float ph =
          wsum(w, noise_phi(n0, p.agg_noise) + noise_phi(n1, p.agg_noise));
      if (w.lane == (i & 31)) R.phi[i] += ph;
    }
    // A row takes sample s over only when strictly above its running max:
    // most chunks have none, and skip the reduction.
    const float rm = R.runmax[i];
    if (w.ballot(v0 > rm || v1 > rm) == 0) continue;
    float sm, sc3[3];
    const int sw = warp_first_max(w, v0, v1, &sm);
    warp_row_colour(w, Q, sw, sc3);
    w.sync();
    if (w.lane == (i & 31)) {
      R.runmax[i] = sm;
      R.winid[i] = (float)(cid * kChunk + sw);
      for (int c = 0; c < 3; ++c) R.winc[c * R.S + i] = sc3[c];
    }
  }
  w.sync();
}

// One chunk of B1 at one pixel: the forward replay of R's samples, with
// (for the record's first samples) the alpha product, the exclusion track
// when TRACK_ALPHA (K6), the softmax, the control variate and nreal.  scr:
// the warp's scratch of 4 x 64 floats (the softmax's sums).
template <bool TRACK_ALPHA, bool MULTI, class Wp>
PT_HD void warp_chunk_forward(const Params& p, const Tables& T, int b,
                              int cid, float px, float py, bool live,
                              uint32_t pos, Wp& w, const Rec& R, float* scr) {
  const float* sc = T.sc;
  PairRows Q;
  pair_rows(p, T, b, cid, w.lane, px, py, live, pos, false, false, Q);
  if (MULTI && R.s0 > 0) {
    warp_chunk_samples(p, sc, b, cid, pos, w, R, Q);
    return;
  }
  float* h = R.h;
  const float alpha =
      h[kRAlpha] * warp_prod_rows(w, 1.0f - Q.prob[0], 1.0f - Q.prob[1]);
  float zcnt = 0.0f, pnz = 0.0f;
  if (TRACK_ALPHA) {
    const bool o0 = Q.prob[0] >= 1.0f, o1 = Q.prob[1] >= 1.0f;
    zcnt = h[kRZcnt] + (float)(pt_popc(w.ballot(o0)) + pt_popc(w.ballot(o1)));
    pnz = h[kRPnz] * warp_prod_rows(w, o0 ? 1.0f : 1.0f - Q.prob[0],
                                    o1 ? 1.0f : 1.0f - Q.prob[1]);
  }
  const float gamma = sc[kGamma];
  if (p.agg_kind == kAggSoft) {
    float m_new, scale, sums[4];
    warp_softmax_chunk(w, Q, gamma, h[kRM], scr, &m_new, &scale, sums);
    if (w.lane == 0) {
      h[kRAlpha] = alpha;
      if (TRACK_ALPHA) {
        h[kRZcnt] = zcnt;
        h[kRPnz] = pnz;
      }
      h[kRDen] = h[kRDen] * scale + sums[0];
      for (int c = 0; c < 3; ++c)
        h[kRNum + c] = h[kRNum + c] * scale + sums[c + 1];
      h[kRM] = m_new;
    }
    return;
  }
  // The control variate: the argmax of z_map.
  float mx = 0.0f, col[3];
  const float rm0 = h[kRRm0];
  const bool cv = w.ballot(Q.zmap[0] > rm0 || Q.zmap[1] > rm0) != 0;
  if (cv) warp_row_colour(w, Q, warp_first_max(w, Q.zmap[0], Q.zmap[1], &mx),
                          col);
  warp_chunk_samples(p, sc, b, cid, pos, w, R, Q);
  if (w.lane == 0) {
    h[kRAlpha] = alpha;
    if (TRACK_ALPHA) {
      h[kRZcnt] = zcnt;
      h[kRPnz] = pnz;
    }
    if (cv) {
      h[kRRm0] = mx;
      for (int c = 0; c < 3; ++c) h[kRW0c + c] = col[c];
    }
    h[kRNreal] += (float)kChunk;
  }
}

// The pixel's colour from its record (lane 0).
PT_HD void rec_rgb(const Params& p, const Rec& R, float rgb[3]) {
  if (p.agg_kind == kAggSoft) {
    for (int c = 0; c < 3; ++c) rgb[c] = R.h[kRNum + c] / R.h[kRDen];
    return;
  }
  for (int c = 0; c < 3; ++c) {
    float sum = 0.0f;
    for (int s = 0; s < R.S; ++s) sum += R.winc[c * R.S + s];
    rgb[c] = sum / (float)R.S;
  }
}

// ---- K5: the forward alone (stream_forward.cu) ----------------------------
//
// B1 without what only the gradients need: no phi, no coverage score
// coefficient, no exclusion track, no control variate, no record in
// device memory.  A pixel's state (Fwd) sits in shared memory: the head
// (alpha product, online softmax, the colour sums of the passes done)
// and, per aggregation sample of the pass, the running max and the
// winner's sorted row (lane l keeps samples l and l + 32).  The argmax
// aggregations shade no row during the sweep: at the end of a pass each
// sample's winner is shaded once, from the table in device memory
// (fwd_pass_end), by the same face_geometry / face_shade as the sweep
// would, so its colour has the same bits.
//
// Noise is drawn only where a draw can change the image (PRUNE; the host
// tests also build K5 without it and compare the bits), and the draws a
// warp needs are packed across its lanes.  Coverage: a candidate row with
// |d| > fl(|sigma| B) (B = noise_bound) hits in every sample (d < 0) or in
// none, since fl(sigma n) lies within +-fl(|sigma| B) and rounding is
// monotone; it takes that count, the float sum its draws give.  The
// (pair, sample) draws of the rows in the band are listed and spread over
// the lanes (warp_coverage); each hit adds 1 to its row's integer count.
// Aggregation: with gb = fl(|gamma| B), row r's perturbed value fl(z_r +
// fl(gamma n)) lies in [fl(z_r - gb), fl(z_r + gb)].  So a row with
// fl(z_r + gb) <= the sample's running max can never take the sample over
// (the winner must be strictly greater), and one with fl(z_r + gb) < lim
// = max_r' fl(z_r' - gb) stays below the chunk's max, which is at least
// lim: it can be neither the chunk's first max nor change whether the
// chunk beats the running max.  A lane's pair is drawn for a sample only
// if one of its rows passes both tests; the (pair, sample) draws of
// kAggBatch samples are listed and spread over the lanes, their values
// left in the warp's scratch.  A live pair left undrawn takes -inf, which
// changes neither the max nor its first row; a pair with no candidate
// keeps z_map + gamma 0, as the per-row rule gives it.  The winner rule
// stays the per-row scan's: strictly greater across chunks, first row
// within a chunk.
//
// Above kMaxS samples the first pass leaves each visited pixel's z_map
// rows and candidacy in device memory (p.zbuf, p.zmask); the later passes
// read them instead of recomputing det1 and the coverage.
// Counts of K5's counting build (stream_forward.cu) for a lane: draws in
// Box-Muller pairs (Cauchy: pairs of draws), those the rule "every pair
// with a candidate row, every sample, once" takes (need) and those taken
// (drawn); and the rows the argmax aggregations must shade, each pixel's
// distinct winners of a pass (fwd_count_winners).
struct DrawCounts {
  unsigned long long cover_need, cover_drawn, agg_need, agg_drawn, winners;
};

enum FwdHead { kFAlpha = 0, kFM, kFDen, kFNum, kFSum = kFNum + 3,
               kFHead = kFSum + 3 };
constexpr int kAggBatch = 4;   // samples whose draws are packed together

// A pixel's state in floats: the head and 2 per sample of a pass.
PT_HOST_HD int fwd_floats(const Params& p) {
  return kFHead + 2 * min(agg_samples(p), kMaxS);
}

// A warp's scratch in 4-byte words: the packed list, the rows' coverage
// hit counts, and the sampled values (also the softmax's sums and the
// winners' colours).
constexpr int kFwdList = kAggBatch * 32;
constexpr int kFwdScratch = kFwdList + kChunk + kAggBatch * kChunk;

struct FwdScratch {
  int *list, *hits;
  float* vals;
};

PT_HD FwdScratch fwd_scratch(float* base) {
  FwdScratch s;
  s.list = reinterpret_cast<int*>(base);
  s.hits = s.list + kFwdList;
  s.vals = base + kFwdList + kChunk;
  return s;
}

// Pass k's view of a pixel's state at `base`: samples s0 .. s0 + ns - 1.
struct Fwd {
  float *h, *runmax, *win;
  int W, s0, ns;
};

PT_HD Fwd fwd_at(const Params& p, float* base, int k) {
  Fwd r;
  r.W = min(agg_samples(p), kMaxS);
  r.h = base;
  r.runmax = base + kFHead;
  r.win = r.runmax + r.W;
  r.s0 = k * kMaxS;
  r.ns = min(kMaxS, agg_samples(p) - r.s0);
  return r;
}

// The state before the pass's first chunk: the background channel alone
// (the head in the first pass only).
template <class Wp>
PT_HD void fwd_init(const Params& p, const float* sc, int b, uint32_t pos,
                    Wp& w, const Fwd& R) {
  if (w.lane == 0 && R.s0 == 0) {
    float* h = R.h;
    h[kFAlpha] = 1.0f;
    h[kFM] = p.eps_bg * (1.0f / sc[kGamma]);
    h[kFDen] = 1.0f;
    for (int c = 0; c < 3; ++c) {
      h[kFNum + c] = sc[kBg + c];
      h[kFSum + c] = 0.0f;
    }
  }
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  for (int i = w.lane; i < R.ns; i += 32) {
    float phi;
    R.runmax[i] = bg_start(p, sc, a0, a1, R.s0 + i, pos, &phi);
    R.win[i] = -1.0f;
  }
  w.sync();
}

// After a pass: each sample's winner shaded (row win from the sorted table
// in device memory; the background where no row won), then the colours
// added to the sums in s order (lane 0).
template <class Wp>
PT_HD void fwd_pass_end(const Params& p, const float* sc, int b, float px,
                        float py, Wp& w, const Fwd& R, const FwdScratch& S) {
  if (p.agg_kind != kAggSoft) {
    for (int i = w.lane; i < R.ns; i += 32) {
      const int r = (int)R.win[i];
      float col[3] = {sc[kBg], sc[kBg + 1], sc[kBg + 2]};
      if (r >= 0) {
        const Tables T = chunk_tables(
            p, p.tab + ((size_t)b * p.rw + (size_t)(r - r % kChunk)) * p.dt,
            sc);
        float d, z, m, w3[3];
        face_geometry(p, T, r % kChunk, px, py, true, &d, &z, &m, w3);
        face_shade(p, T, r % kChunk, m, w3, col);
      }
      for (int c = 0; c < 3; ++c) S.vals[c * kMaxS + i] = col[c];
    }
    w.sync();
    if (w.lane == 0)
      for (int c = 0; c < 3; ++c)
        for (int i = 0; i < R.ns; ++i) R.h[kFSum + c] += S.vals[c * kMaxS + i];
  }
  w.sync();
}

// The pass's distinct winning rows of the pixel (the background left
// out) into the lanes' dc.winners: the shading the argmax aggregations
// need, whatever the order of the samples.  Call after fwd_pass_end.
template <class Wp>
PT_HD void fwd_count_winners(const Params& p, Wp& w, const Fwd& R,
                             DrawCounts& dc) {
  if (p.agg_kind == kAggSoft) return;
  for (int i = w.lane; i < R.ns; i += 32) {
    const float r = R.win[i];
    bool first = r >= 0.0f;
    for (int j = 0; j < i && first; ++j) first = R.win[j] != r;
    dc.winners += first ? 1 : 0;
  }
  w.sync();
}

// The pixel's RGBA once every pass is done (lane 0).
PT_HD void fwd_rgba(const Params& p, const Fwd& R, float out[4]) {
  for (int c = 0; c < 3; ++c)
    out[c] = p.agg_kind == kAggSoft ? R.h[kFNum + c] / R.h[kFDen]
                                    : R.h[kFSum + c] / (float)agg_samples(p);
  out[3] = 1.0f - R.h[kFAlpha];
}

// Coverage and z_map of the lane's rows h and h + 32, the MC draws packed
// across the warp (PRUNE: only the rows in the band draw; else every
// candidate row).  S.hits is zero on entry and on exit.
template <bool PRUNE, bool COUNT, class Wp>
PT_HD void warp_coverage(const Params& p, const float* sc, int b, int cid,
                         uint32_t pos, Wp& w, PairRows& R,
                         const FwdScratch& S, DrawCounts& dc) {
  if (p.rast_kind == kRastMC) {
    const float sigma = sc[kSigma];
    bool draw[2];
    for (int k = 0; k < 2; ++k) {
      R.prob[k] = R.coeff[k] = 0.0f;
      draw[k] = R.mk[k] != 0.0f;
    }
    if (COUNT && (draw[0] || draw[1])) dc.cover_need += p.s_rast;
    if (PRUNE) {
      const float sb = fabsf(sigma) * noise_bound(p.rast_noise);
      for (int k = 0; k < 2; ++k) {
        if (!draw[k]) continue;
        if (-R.dist[k] > sb) {
          draw[k] = false;
          R.prob[k] = (float)p.s_rast;
        } else if (R.dist[k] > sb) {
          draw[k] = false;
        }
      }
    }
    if (COUNT && (draw[0] || draw[1])) dc.cover_drawn += p.s_rast;
    const int nd = warp_append(w, draw[0] || draw[1], w.lane, S.list, 0);
    w.sync();
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
    const uint32_t base = (uint32_t)(cid * kChunk);
    const int mine = (draw[0] ? 1 : 0) | (draw[1] ? 2 : 0);
    // Draw j: pair list[j % nd], sample j / nd.
    const int total = nd * p.s_rast;
    for (int j0 = 0; j0 < total; j0 += 32) {
      const int j = j0 + w.lane;
      const bool on = j < total;
      const int h = on ? S.list[j % nd] : 0;
      const float d0 = w.shfl(R.dist[0], h), d1 = w.shfl(R.dist[1], h);
      const int e = w.shfl(mine, h);
      if (on) {
        float nz[2];
        noise_pair(p.rast_noise, s0, s1, j / nd, base, h, pos, &nz[0],
                   &nz[1]);
        if ((e & 1) && -d0 + sigma * nz[0] >= 0.0f)
          pt_atomic_add(&S.hits[h], 1);
        if ((e & 2) && -d1 + sigma * nz[1] >= 0.0f)
          pt_atomic_add(&S.hits[h + kHalf], 1);
      }
    }
    w.sync();
    for (int k = 0; k < 2; ++k) {
      int* hit = &S.hits[w.lane + k * kHalf];
      if (draw[k]) R.prob[k] = (float)*hit;
      *hit = 0;
    }
  }
  pair_finish(p, sc, R);
}

// One chunk of K5 at one pixel: the pass's samples, with (in the first
// pass) the alpha product and the softmax.  zb / zm: the pixel's z_map
// rows and candidacy mask for this visit in device memory (MULTI: written
// in the first pass, read in the later ones, which need no table).  dc:
// the lane's draw counts (COUNT).  Phases of a -DPT_PROFILE build: 0 det1
// (and shading for the softmax), 1 coverage and z_map, 2 aggregation
// draws, 3 the rest (alpha, softmax, winner scans).
template <bool MULTI, bool PRUNE, bool COUNT, class Wp>
PT_HD void warp_forward_chunk(const Params& p, const Tables& T, int b,
                              int cid, float px, float py, uint32_t pos,
                              Wp& w, const Fwd& R, const FwdScratch& S,
                              DrawCounts& dc, float* zb,
                              unsigned long long* zm) {
  const float* sc = T.sc;
  PT_MARK(clk);
  const bool soft = p.agg_kind == kAggSoft;
  const bool first = !MULTI || R.s0 == 0;
  PairRows Q;
  float alpha = 0.0f;
  float* h = R.h;
  if (first) {
    if (soft) {
      pair_geometry(p, T, w.lane, px, py, true, false, Q);
    } else {
      for (int k = 0; k < 2; ++k) {
        float w3[3];
        face_geometry(p, T, w.lane + k * kHalf, px, py, true, &Q.dist[k],
                      &Q.z[k], &Q.mk[k], w3);
      }
    }
    PT_PHASE(0, clk);
    warp_coverage<PRUNE, COUNT>(p, sc, b, cid, pos, w, Q, S, dc);
    if (MULTI) {
      zb[w.lane] = Q.zmap[0];
      zb[w.lane + kHalf] = Q.zmap[1];
      const unsigned lo = w.ballot(Q.mk[0] != 0.0f);
      const unsigned hi = w.ballot(Q.mk[1] != 0.0f);
      if (w.lane == 0)
        *zm = (unsigned long long)lo | ((unsigned long long)hi << 32);
    }
    alpha = h[kFAlpha] * warp_prod_rows(w, 1.0f - Q.prob[0],
                                        1.0f - Q.prob[1]);
  } else {
    const unsigned long long m = *zm;
    Q.zmap[0] = zb[w.lane];
    Q.zmap[1] = zb[w.lane + kHalf];
    Q.mk[0] = (m >> w.lane) & 1ull ? 1.0f : 0.0f;
    Q.mk[1] = (m >> (w.lane + kHalf)) & 1ull ? 1.0f : 0.0f;
  }
  PT_PHASE(1, clk);
  const float gamma = sc[kGamma];
  if (soft) {
    float m_new, scale, sums[4];
    warp_softmax_chunk(w, Q, gamma, h[kFM], S.vals, &m_new, &scale, sums);
    if (w.lane == 0) {
      h[kFAlpha] = alpha;
      h[kFDen] = h[kFDen] * scale + sums[0];
      for (int c = 0; c < 3; ++c)
        h[kFNum + c] = h[kFNum + c] * scale + sums[c + 1];
      h[kFM] = m_new;
    }
    PT_PHASE(3, clk);
    return;
  }
  const bool mc = p.agg_kind == kAggMC;
  const bool live = Q.mk[0] != 0.0f || Q.mk[1] != 0.0f;
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  const uint32_t base = (uint32_t)(cid * kChunk);
  // The pruning bounds: each row's highest value, and lim.
  float top0 = Q.zmap[0], top1 = Q.zmap[1];
  bool may0 = true, may1 = true;
  if (PRUNE && mc) {
    const float gb = fabsf(gamma) * noise_bound(p.agg_noise);
    top0 = Q.zmap[0] + gb;
    top1 = Q.zmap[1] + gb;
    const float lim = wmax(w, fmaxf(Q.zmap[0] - gb, Q.zmap[1] - gb));
    may0 = !(top0 < lim);
    may1 = !(top1 < lim);
  }
  PT_PHASE(3, clk);
  for (int i0 = 0; i0 < R.ns; i0 += kAggBatch) {
    const int nb = min(kAggBatch, R.ns - i0);
    unsigned drawn = 0;          // bit t: the lane's pair drawn for i0 + t
    if (mc) {
      int items = 0;
      for (int t = 0; t < nb; ++t) {
        const float rm = R.runmax[i0 + t];
        bool draw = live;
        if (PRUNE)
          draw = live && ((may0 && !(top0 <= rm)) || (may1 && !(top1 <= rm)));
        if (COUNT) {
          dc.agg_need += live ? 1 : 0;
          dc.agg_drawn += draw ? 1 : 0;
        }
        drawn |= (draw ? 1u : 0u) << t;
        items += warp_append(w, draw, t * 32 + w.lane, S.list, items);
      }
      w.sync();
      // Item j: (sample i0 + t, pair h), its two values into vals.
      for (int j0 = 0; j0 < items; j0 += 32) {
        const int j = j0 + w.lane;
        const int code = j < items ? S.list[j] : 0;
        const int t = code >> 5, hh = code & 31;
        const float z0 = w.shfl(Q.zmap[0], hh), z1 = w.shfl(Q.zmap[1], hh);
        if (j < items) {
          float n0, n1;
          noise_pair(p.agg_noise, a0, a1, R.s0 + i0 + t, base, hh, pos, &n0,
                     &n1);
          S.vals[t * kChunk + hh] = z0 + gamma * n0;
          S.vals[t * kChunk + hh + kHalf] = z1 + gamma * n1;
        }
      }
      w.sync();
      PT_PHASE(2, clk);
    }
    for (int t = 0; t < nb; ++t) {
      const int i = i0 + t;
      const float rm = R.runmax[i];
      float v0 = Q.zmap[0], v1 = Q.zmap[1];
      if (mc) {
        if ((drawn >> t) & 1u) {
          v0 = S.vals[t * kChunk + w.lane];
          v1 = S.vals[t * kChunk + w.lane + kHalf];
        } else if (PRUNE && live) {
          v0 = v1 = -INFINITY;
        } else {
          v0 = Q.zmap[0] + gamma * 0.0f;
          v1 = Q.zmap[1] + gamma * 0.0f;
        }
      }
      if (w.ballot(v0 > rm || v1 > rm) == 0) continue;
      float sm;
      const int sw = warp_first_max(w, v0, v1, &sm);
      if (w.lane == (i & 31)) {
        R.runmax[i] = sm;
        R.win[i] = (float)(cid * kChunk + sw);
      }
    }
    w.sync();
    PT_PHASE(3, clk);
  }
  if (first && w.lane == 0) h[kFAlpha] = alpha;
}

// Between the sweeps, lane 0 at one live pixel: the output cotangent (K6:
// g_out; K7: the image loss's, derived in place from the target) into the
// record, and the per-pixel terms of the aggregation that need no chunk:
// background colour, the MC gamma term, the softmax background weight.
// An inactive tile (active false) stops here: background colour gradient
// (and loss) only.
template <bool LOSS>
PT_HD void warp_post(const Params& p, const float* sc, int b, int pix,
                     bool active, const Rec& R, PixelAcc& acc) {
  const int npix = p.image_size * p.image_size;
  float* h = R.h;
  float g_rgb[3], g_alpha = 0.0f;
  if (LOSS) {
    float rgb[3];
    rec_rgb(p, R, rgb);
    const float* tg = p.extra + (size_t)b * 3 * npix + pix;
    for (int c = 0; c < 3; ++c) {
      const float d = rgb[c] - tg[(size_t)c * npix];
      if (p.loss_kind == kL2) {
        acc.loss += d * d;
        g_rgb[c] = 2.0f * d * p.lscale;
      } else {
        acc.loss += fabsf(d);
        g_rgb[c] = (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f)) * p.lscale;
      }
    }
  } else {
    const float* go = p.extra + ((size_t)b * npix + pix) * 4;
    for (int c = 0; c < 3; ++c) g_rgb[c] = go[c];
    g_alpha = go[3];
  }
  for (int c = 0; c < 3; ++c) h[kRGrgb + c] = g_rgb[c];
  h[kRGalpha] = g_alpha;
  if (!active) {
    for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += g_rgb[c];
    return;
  }
  const float gamma = sc[kGamma];
  if (p.agg_kind == kAggSoft) {
    float rgb[3];
    rec_rgb(p, R, rgb);
    const float dot_w = rgb[0] * g_rgb[0] + rgb[1] * g_rgb[1] +
                        rgb[2] * g_rgb[2];
    h[kRDotw] = dot_w;
    const float x_bg = p.eps_bg * (1.0f / gamma);
    const float w_bg = expf(x_bg - h[kRM]) / h[kRDen];
    float bgdot = 0.0f;
    for (int c = 0; c < 3; ++c) {
      acc.gsc[kBg + c] += w_bg * g_rgb[c];
      bgdot += sc[kBg + c] * g_rgb[c];
    }
    const float gb_x = w_bg * (bgdot - dot_w);
    // gamma, znear and zfar reach the softmax only through z / gamma, z =
    // eps for the background and z_inv for a row; sum g_x = 0 over both.
    // Each z is taken less c = the pixel's max z_map (m * gamma), exact in
    // real arithmetic, so the rows' sum G = sum g_x (z_inv - c) (in
    // g_invgam, warp_chunk_grads) does not cancel: gamma takes -(G + (eps
    // - c) gb_x) / gamma^2, znear (G - c gb_x) / (gamma zden) and zfar
    // -(G + (1 - c) gb_x) / (gamma zden).  Here the background's share;
    // stream_finish adds G's.
    const float c = h[kRM] * gamma;
    const float gz_den = gamma * (sc[kZfar] - sc[kZnear]);
    acc.gsc[kGamma] += -((p.eps_bg - c) * gb_x) / (gamma * gamma);
    acc.gsc[kZnear] += -(c * gb_x) / gz_den;
    acc.gsc[kZfar] += -((1.0f - c) * gb_x) / gz_den;
    return;
  }
  const int S = R.S;
  const float comp = (float)p.k - h[kRNreal];
  float gterm = 0.0f, wbg = 0.0f;
  for (int s = 0; s < S; ++s) {
    float d = 0.0f;
    for (int c = 0; c < 3; ++c)
      d += (R.winc[c * S + s] - h[kRW0c + c]) * g_rgb[c];
    R.dot[s] = d;
    gterm += d * (R.phi[s] + comp - 1.0f);
    wbg += R.winid[s] >= (float)p.rw ? 1.0f : 0.0f;
  }
  if (p.agg_kind == kAggMC) acc.gsc[kGamma] += gterm / ((float)S * gamma);
  wbg = wbg / (float)S;
  for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += wbg * g_rgb[c];
}

// One chunk of B2 at one pixel: the adjoints of the aggregation, z_map,
// the alpha product, coverage and det1 of the lane's rows h and h + 32,
// each candidate row's table gradient added into the warp's slice (row r
// at slice + r * ds); any[k] notes a candidate in row h + 32 k.
template <bool TRACK_ALPHA, class Wp>
PT_HD void warp_chunk_grads(const Params& p, const Tables& T, int b, int cid,
                            float px, float py, bool live, uint32_t pos,
                            Wp& w, const Rec& R, float* slice, int ds,
                            PixelAcc& acc, bool any[2]) {
  const float* sc = T.sc;
  PairRows Q;
  pair_rows(p, T, b, cid, w.lane, px, py, live, pos, true, false, Q);
  const float* h = R.h;
  const float g_rgb[3] = {h[kRGrgb], h[kRGrgb + 1], h[kRGrgb + 2]};
  const float gamma = sc[kGamma];
  // Aggregation cotangents, per row: z_map (gz) and colour (gc).
  float gz[2] = {0.0f, 0.0f}, gc[2][3] = {{0.0f, 0.0f, 0.0f},
                                           {0.0f, 0.0f, 0.0f}};
  if (p.agg_kind == kAggSoft) {
    // x = log(prob) / alpha + z_inv / gamma: gamma, znear and zfar reach
    // it through z_inv / gamma alone, so g_invgam sums g_x (z_inv - c) (c
    // as warp_post's), and neither the z_map's gamma / alpha factor
    // (stream_finish) nor the rows' z_inv adjoint (below) books them.
    // Apart, the gamma paths are large sums of log(prob) g_x that cancel
    // exactly, and the z_inv adjoints sums of z_inv g_x whose g_x cancel:
    // their float32 rounding was what those gradients kept.
    const float inv_g = 1.0f / gamma;
    const float zshift = h[kRM] * gamma;
    const float zfar = sc[kZfar], znear = sc[kZnear];
    for (int k = 0; k < 2; ++k) {
      const float x = Q.zmap[k] * inv_g;
      const float wgt = expf(x - h[kRM]) / h[kRDen];
      const float gwr = Q.col[k][0] * g_rgb[0] + Q.col[k][1] * g_rgb[1] +
                        Q.col[k][2] * g_rgb[2];
      const float g_x = wgt * (gwr - h[kRDotw]);
      gz[k] = g_x * inv_g;
      const float zinv = (zfar - Q.z[k]) / (zfar - znear) * Q.mk[k];
      acc.g_invgam += (isinf(Q.zmap[k]) ? 0.0f : zinv - zshift) * g_x;
      for (int c = 0; c < 3; ++c) gc[k][c] = wgt * g_rgb[c];
    }
  } else {
    const int S = R.S;
    const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
    const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
    const uint32_t base = (uint32_t)(cid * kChunk);
    const bool draw = Q.mk[0] != 0.0f || Q.mk[1] != 0.0f;
    for (int s = 0; s < S; ++s) {
      const int wr = (int)R.winid[s] - cid * kChunk;
      if (wr >= 0 && wr < kChunk && (wr & (kHalf - 1)) == w.lane)
        for (int c = 0; c < 3; ++c) {
          if (wr < kHalf)
            gc[0][c] += g_rgb[c];
          else
            gc[1][c] += g_rgb[c];
        }
      if (p.agg_kind != kAggMC || !draw) continue;
      // Only candidate rows carry the z_map cotangent any further.
      float n0, n1;
      noise_pair(p.agg_noise, a0, a1, s, base, w.lane, pos, &n0, &n1);
      const float dot = R.dot[s];
      gz[0] += dot * score(n0, p.agg_noise);
      gz[1] += dot * score(n1, p.agg_noise);
    }
    const float sg = (float)S * gamma;
    for (int k = 0; k < 2; ++k) {
      gz[k] = gz[k] / sg;
      for (int c = 0; c < 3; ++c) gc[k][c] = gc[k][c] / (float)S;
    }
  }

  const bool hard_agg = p.agg_kind == kAggHard;
  const float gal = hard_agg ? 1e-6f : sc[kGamma] / sc[kAlpha];
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const float zden = zfar - znear;
  const float sigma = sc[kSigma];
  const float g_alpha = h[kRGalpha], zcnt = h[kRZcnt], pnz = h[kRPnz];
  const int dense = p.atlas_r == 0 ? 9 : (p.atlas_r == 1 ? 3 : 0);
  for (int k = 0; k < 2; ++k) {
    if (Q.mk[k] == 0.0f) continue;
    any[k] = true;
    const int r = w.lane + k * kHalf;
    const float prob = Q.prob[k];
    // z_map = scaled(log prob) + z_inv.
    const float g_zm = gz[k];
    const float lp = logf(prob);
    float g_lp;
    if (hard_agg) {
      g_lp = 1e-6f * g_zm;
    } else {
      const float gy = gal * g_zm;
      g_lp = isnan(gy) ? 0.0f : gy;
      const float term = (isinf(lp) ? 0.0f : lp) * g_zm;
      if (!isnan(term)) acc.g_gal += term;
    }
    float inv = 1.0f / prob;
    if (isinf(inv)) inv = 0.0f;
    float g_prob = inv * g_lp;
    const float g_q = g_zm * Q.mk[k];
    const float num = zfar - Q.z[k];
    const float g_num = g_q / zden;
    const float g_den = -g_q * num / (zden * zden);
    if (p.agg_kind != kAggSoft) {       // the softmax's: warp_post
      acc.gsc[kZfar] += g_num + g_den;
      acc.gsc[kZnear] -= g_den;
    }
    const float g_z = -g_num;
    if (TRACK_ALPHA) {       // alpha = 1 - prod(1 - p): exclusion products
      const bool one = prob >= 1.0f;
      const float excl = one ? (zcnt == 1.0f ? pnz : 0.0f)
                             : (zcnt == 0.0f ? pnz / (1.0f - prob) : 0.0f);
      g_prob = g_prob + (-g_alpha) * (-excl);
    }
    const float g_raw = g_prob * Q.mk[k];
    float g_dist = 0.0f;
    if (p.rast_kind == kRastMC) {
      const float g_d = Q.coeff[k] * g_raw;
      g_dist = -g_d;
      acc.gsc[kSigma] += g_d;
    } else if (p.rast_kind != kRastHard) {
      const float nd = -Q.dist[k];
      const float x = nd / sigma;
      float g_x;
      if (p.rast_kind == kRastSoft) {
        g_x = g_raw * prob * (1.0f - prob);
      } else {
        const float p1 = x > 0.5f ? 1.0f : x + 0.5f;
        g_x = x > 0.5f ? 0.0f : g_raw * tie_max(p1, 0.0f);
      }
      g_dist = -(g_x / sigma);
      acc.gsc[kSigma] += -g_x * nd / (sigma * sigma);
    }
    float gslot[kGeo + 9];
    for (int d = 0; d < kGeo + 9; ++d) gslot[d] = 0.0f;
    int cell = -1;
    float gcell[3] = {0.0f, 0.0f, 0.0f};
    face_backward(p, T, r, px, py, g_dist, g_z, gc[k], gslot, &cell, gcell,
                  acc.gsc);
    float* row = slice + r * ds;
    for (int d = 0; d < 9; ++d) row[d] += gslot[d];
    if (p.phong)
      for (int d = 9; d < kGeo; ++d) row[d] += gslot[d];
    for (int d = kGeo; d < kGeo + 9; ++d)
      if (d < kGeo + dense) row[d] += gslot[d];
    if (p.atlas_r > 1 && cell >= 0)
      for (int c = 0; c < 3; ++c) row[kGeo + cell * 3 + c] += gcell[c];
  }
}

// The row stride of a warp's slice: odd, so lane h's row h and its
// neighbours' fall in distinct banks.
PT_HOST_HD int slice_stride(const Params& p) { return (kGeo + p.tex_d) | 1; }

// Shared memory of the two kernels in floats.  B1's: two chunk buffers,
// the scalars and the pixels' records (windows above kMaxS samples); B2's
// with `warps` warps per block: the chunk buffer, the warps' slices, the
// scalars and the records (above kMaxS samples their heads: B2 reads the
// per-sample arrays from device memory).
PT_HOST_HD size_t replay_floats(const Params& p) {
  return 2 * (size_t)kChunk * p.dt + ((kNS + 3) & ~3) +
         (size_t)kStreamWarps * 4 * kChunk +
         (size_t)kBlockPix * rec_window_floats(p);
}

PT_HOST_HD size_t adjoint_floats(const Params& p, int warps) {
  return (size_t)kChunk * p.dt +
         (((size_t)warps * kChunk * slice_stride(p) + 3) & ~(size_t)3) +
         ((kNS + 3) & ~3) + (size_t)kBlockPix * rec_window_floats(p);
}

#ifdef __CUDACC__
// The block's work: 32 pixels of tile t of batch element b (sub the
// block's place in the tile), the tile's chunk list and count (0 for an
// inactive tile), and the block's records in device memory.
struct StreamBlock {
  int b, t, sub, bt, n;
  bool active;
  const int* list;
  float* recs;
  __device__ StreamBlock(const Params& p, int rf) {
    b = blockIdx.y;
    t = blockIdx.x / p.nsub;
    sub = blockIdx.x % p.nsub;
    bt = b * p.nt + t;
    active = p.active[bt] > 0;
    n = active ? p.count[bt] : 0;
    list = p.rows + (size_t)bt * p.nch;
    recs = p.recs ? p.recs + ((size_t)bt * p.nsub + sub) * kBlockPix * rf
                  : nullptr;
  }
  __device__ const float* chunk(const Params& p, int q) const {
    return p.tab + ((size_t)b * p.rw + (size_t)list[q] * kChunk) * p.dt;
  }
  __device__ int pixel(const Params& p, int i, bool* live) const {
    return tile_pixel(p, t, sub * kBlockPix + i, live);
  }
};

// B1 and the post step: the replay over the tile's chunk list, chunks
// double-buffered by bulk copies; then each live pixel's cotangents.  The
// records go to device memory for B2, the post step's scalar sums (its
// warps in order) to the block's scalar row.  No slices: a smaller block
// than B2's, so more of them are resident on an SM.
template <bool LOSS, bool MULTI>
__global__ void __launch_bounds__(kStreamWarps * 32, 4)
stream_replay_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ double wtot[kStreamWarps][kTot];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int tid = threadIdx.x, rf = rec_floats(p);
  CardWarp w{tid & 31};
  const StreamBlock B(p, rf);
  const size_t chunk = (size_t)kChunk * p.dt;
  float* s_sc = smem + 2 * chunk;
  float* scr = s_sc + ((kNS + 3) & ~3) + warp * 4 * kChunk;
  float* recs = s_sc + ((kNS + 3) & ~3) + kStreamWarps * 4 * kChunk;
  for (int k = tid; k < kNS; k += blockDim.x)
    s_sc[k] = p.scal[(size_t)B.b * kNS + k];
  for (int k = tid; k < kStreamWarps * kTot; k += blockDim.x)
    wtot[k / kTot][k % kTot] = 0.0;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();
  const unsigned cbytes = (unsigned)(chunk * sizeof(float));
  const int passes = MULTI ? stream_passes(p) : 1;
  const int rw = MULTI ? rec_window_floats(p) : rf;
  auto window = [&](int i, int k) {
    return rec_pass<MULTI>(p, recs + i * rw, k);
  };
  auto whole = [&](int i) {
    return rec_whole<MULTI>(p, recs + i * rw, B.recs + (size_t)i * rf);
  };
  PT_MARK(clk);
  // Visits v = k n + q: pass k's chunk q, double-buffered across passes.
  const int visits = passes * B.n;
  if (visits > 0 && tid == 0)
    bulk_fetch(smem, B.chunk(p, 0), cbytes, &bar[0]);
  for (int k = 0; k < passes; ++k) {
    // The warp's pixels: i = warp, warp + nw, ... of the block's 32.
    for (int i = warp; i < kBlockPix; i += nw) {
      bool live;
      const int pix = B.pixel(p, i, &live);
      warp_state_init(p, s_sc, B.b, (uint32_t)pix, w, window(i, k));
    }
    for (int q = 0; q < B.n; ++q) {
      const int v = k * B.n + q, cur = v & 1;
      if (v + 1 < visits && tid == 0)
        bulk_fetch(cur ? smem : smem + chunk,
                   B.chunk(p, MULTI ? (v + 1) % B.n : v + 1), cbytes,
                   &bar[cur ^ 1]);
      mbar_wait(&bar[cur], (v >> 1) & 1);   // buffer cur's (v / 2)-th fill
      const Tables T = chunk_tables(p, cur ? smem + chunk : smem, s_sc);
      for (int i = warp; i < kBlockPix; i += nw) {
        bool live;
        const int pix = B.pixel(p, i, &live);
        if (!live) continue;
        float px, py;
        pixel_center(p.image_size, pix, &px, &py);
        warp_chunk_forward<!LOSS, MULTI>(p, T, B.b, B.list[q], px, py, live,
                                         (uint32_t)pix, w, window(i, k),
                                         scr);
      }
      __syncthreads();
    }
    if (MULTI) {
      for (int i = warp; i < kBlockPix; i += nw)
        rec_window_out(window(i, k), whole(i), w);
      __syncthreads();
    }
  }
  PT_PHASE(0, clk);
  PixelAcc acc;
  acc_clear(acc);
  for (int i = warp; i < kBlockPix; i += nw) {
    bool live;
    const int pix = B.pixel(p, i, &live);
    if (live && w.lane == 0)
      warp_post<LOSS>(p, s_sc, B.b, pix, B.active, whole(i), acc);
  }
  __syncwarp();
  warp_fold(w, acc, wtot[warp]);
  __syncthreads();
  // The records to device memory: whole in one pass, else their heads.
  if (MULTI) {
    for (int k = tid; k < kBlockPix * kRHead; k += blockDim.x)
      B.recs[(size_t)(k / kRHead) * rf + k % kRHead] =
          recs[(k / kRHead) * rw + k % kRHead];
  } else {
    for (int k = tid; k < kBlockPix * rf; k += blockDim.x) B.recs[k] = recs[k];
  }
  if (tid <= kNS) {
    double s = 0.0;
    for (int v = 0; v < nw; ++v) s += wtot[v][tid < kNS ? tid : kNS + 2];
    p.pscal64[((size_t)B.bt * p.nsub + B.sub) * (kNS + 1) + tid] = s;
  }
  PT_PHASE(1, clk);
}

// B2: the adjoints over the chunk list again; the next chunk lands by a
// bulk copy while the block adds the warps' slices into the visit's
// partial rows.  Then the block's scalar row: B1's, B2's warps in order,
// stream_finish.
template <bool LOSS, bool MULTI>
__global__ void __launch_bounds__(kStreamWarps * 32, 2)
stream_adjoint_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ double wtot[kStreamWarps][kTot];
  __shared__ unsigned long long wmask[kStreamWarps];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int tid = threadIdx.x, rf = rec_floats(p), ds = slice_stride(p);
  const int rw = MULTI ? rec_window_floats(p) : rf;
  CardWarp w{tid & 31};
  const StreamBlock B(p, rf);
  double* row = p.pscal64 + ((size_t)B.bt * p.nsub + B.sub) * (kNS + 1);
  const size_t chunk = (size_t)kChunk * p.dt;
  float* buf = smem;
  float* room = smem + chunk;
  float* s_sc = room + (((size_t)nw * kChunk * ds + 3) & ~(size_t)3);
  float* recs = s_sc + ((kNS + 3) & ~3);
  for (int k = tid; k < kNS; k += blockDim.x)
    s_sc[k] = p.scal[(size_t)B.b * kNS + k];
  for (int k = tid; k < kStreamWarps * kTot; k += blockDim.x)
    wtot[k / kTot][k % kTot] = 0.0;
  // The records: whole in one pass, else their heads (the per-sample
  // arrays stay in device memory).
  auto rec = [&](int i) {
    return rec_whole<MULTI>(p, recs + i * rw, B.recs + (size_t)i * rf);
  };
  if (B.n > 0) {
    if (MULTI) {
      for (int k = tid; k < kBlockPix * kRHead; k += blockDim.x)
        recs[(k / kRHead) * rw + k % kRHead] =
            B.recs[(size_t)(k / kRHead) * rf + k % kRHead];
    } else {
      for (int k = tid; k < kBlockPix * rf; k += blockDim.x)
        recs[k] = B.recs[k];
    }
  }
  if (tid == 0) mbar_init(&bar);
  __syncthreads();
  const unsigned cbytes = (unsigned)(chunk * sizeof(float));
  float* slice = room + (size_t)warp * kChunk * ds;
  const int D = kGeo + p.tex_d;
  PixelAcc acc;
  acc_clear(acc);
  PT_MARK(clk);
  if (B.n > 0 && tid == 0) bulk_fetch(buf, B.chunk(p, 0), cbytes, &bar);
  for (int q = 0; q < B.n; ++q) {
    for (int r = w.lane; r < kChunk; r += 32)
      for (int d = 0; d < D; ++d) slice[r * ds + d] = 0.0f;
    bool any[2] = {false, false};
    mbar_wait(&bar, q & 1);
    const Tables T = chunk_tables(p, buf, s_sc);
    for (int i = warp; i < kBlockPix; i += nw) {
      bool live;
      const int pix = B.pixel(p, i, &live);
      if (!live) continue;
      float px, py;
      pixel_center(p.image_size, pix, &px, &py);
      warp_chunk_grads<!LOSS>(p, T, B.b, B.list[q], px, py, live,
                              (uint32_t)pix, w, rec(i), slice, ds, acc, any);
    }
    const unsigned lo = w.ballot(any[0]), hi = w.ballot(any[1]);
    if (w.lane == 0)
      wmask[warp] = (unsigned long long)lo | ((unsigned long long)hi << 32);
    warp_fold(w, acc, wtot[warp]);
    __syncthreads();
    if (q + 1 < B.n && tid == 0) bulk_fetch(buf, B.chunk(p, q + 1), cbytes, &bar);
    unsigned long long mask = 0;
    for (int v = 0; v < nw; ++v) mask |= wmask[v];
    const size_t slot = (size_t)(p.voff[B.bt] + q) * p.nsub + B.sub;
    float* out = p.partial + slot * kChunk * D;
    for (int e = tid; e < kChunk * D; e += blockDim.x) {
      const int r = e / D, d = e - r * D;
      if (!((mask >> r) & 1ull)) continue;
      float s = 0.0f;
      for (int v = 0; v < nw; ++v) s += room[((size_t)v * kChunk + r) * ds + d];
      out[e] = s;
    }
    if (tid == 0) p.pmask[slot] = mask;
    __syncthreads();
  }
  PT_PHASE(2, clk);
  if (tid == 0) {
    StreamAcc tot;
    for (int k = 0; k < kNS; ++k) tot.gsc[k] = row[k];
    tot.loss = row[kNS];
    tot.g_gal = tot.g_invgam = 0.0;
    for (int v = 0; v < nw; ++v) {
      for (int k = 0; k < kNS; ++k) tot.gsc[k] += wtot[v][k];
      tot.g_gal += wtot[v][kNS];
      tot.g_invgam += wtot[v][kNS + 1];
      tot.loss += wtot[v][kNS + 2];
    }
    stream_finish(p, s_sc, tot);
    for (int k = 0; k < kNS; ++k) row[k] = tot.gsc[k];
    row[kNS] = tot.loss;
  }
}

// g_tab (sorted rows): each (batch element, row, column) adds the partial
// rows of its chunk's visits in ascending tile order, each visit's blocks
// in order, skipping the rows a block's mask leaves out.
static __global__ void stream_chunk_reduce(const Params p) {
  const int D = kGeo + p.tex_d;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)p.rw * D) return;
  const int b = blockIdx.y;
  const int row = (int)(idx / D), d = (int)(idx % D);
  const int key = b * p.nch + row / kChunk, r = row % kChunk;
  float s = 0.0f;
  for (int k = p.vstart[key]; k < p.vstart[key + 1]; ++k)
    for (int u = 0; u < p.nsub; ++u) {
      const size_t slot = (size_t)p.vidx[k] * p.nsub + u;
      if ((p.pmask[slot] >> r) & 1ull)
        s += p.partial[(slot * kChunk + r) * D + d];
    }
  p.g_tab[((size_t)b * p.rw + row) * p.dt + d] = s;
}

// g_scal and the loss: the blocks' scalar rows in order, in double.
static __global__ void stream_scal_reduce(const Params p) {
  const int b = blockIdx.x, j = threadIdx.x;
  if (j > kNS) return;
  const size_t blocks = (size_t)p.nt * p.nsub;
  double s = 0.0;
  for (size_t u = 0; u < blocks; ++u)
    s += p.pscal64[((size_t)b * blocks + u) * (kNS + 1) + j];
  if (j < kNS)
    p.g_scal[(size_t)b * kNS + j] = (float)s;
  else
    p.loss[b] = (float)s * p.lscale;
}

// The two kernels' shapes: shape[0] B2's warps per block (4, fewer where a
// large atlas's slices do not fit), shape[1] its dynamic shared memory in
// bytes, shape[2] B1's; their attributes raised to match.
template <bool LOSS, bool MULTI>
static cudaError_t stream_shapes(const Params& p, size_t shape[3]) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes a1, a2;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a1, stream_replay_kernel<LOSS, MULTI>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a2, stream_adjoint_kernel<LOSS, MULTI>);
  if (e != cudaSuccess) return e;
  shape[0] = 0;
  for (int v = kStreamWarps; v >= 1; v >>= 1) {
    const size_t need = sizeof(float) * adjoint_floats(p, v);
    if (need + a2.sharedSizeBytes <= (size_t)optin) {
      shape[0] = v;
      shape[1] = need;
      break;
    }
  }
  shape[2] = sizeof(float) * replay_floats(p);
  if (shape[0] == 0 || shape[2] + a1.sharedSizeBytes > (size_t)optin)
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(stream_adjoint_kernel<LOSS, MULTI>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shape[1]);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(stream_replay_kernel<LOSS, MULTI>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shape[2]);
}

// B1's kernel and B2's.
template <bool LOSS, bool MULTI>
static cudaError_t stream_launch(const Params& p, int n, cudaStream_t st) {
  size_t shape[3];
  cudaError_t e = stream_shapes<LOSS, MULTI>(p, shape);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.nt * p.nsub, n);
  stream_replay_kernel<LOSS, MULTI>
      <<<grid, kStreamWarps * 32, shape[2], st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stream_adjoint_kernel<LOSS, MULTI>
      <<<grid, (int)shape[0] * 32, shape[1], st>>>(p);
  return cudaGetLastError();
}

// The C entries' body: fills Params, launches B1's kernel, B2's and the
// two reductions.  (static per translation unit: K6 and K7 each have one.)
template <bool LOSS>
static int stream_grads_entry(
    const void* tab, const void* rows, const void* count, const void* active,
    const void* voff, const void* vstart, const void* vidx, const void* scal,
    const void* seeds, const void* extra, void* recs, void* partial,
    void* pmask, void* pscal, void* g_tab, void* g_scal, void* loss, int n,
    int nt, int nch, int p_tile, int tile_w, int rw, int dt, int image_size,
    int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, void* stream) {
  Params p = {};
  p.tab = (const float*)tab;
  p.rows = (const int*)rows;
  p.count = (const int*)count;
  p.voff = (const int*)voff;
  p.vstart = (const int*)vstart;
  p.vidx = (const int*)vidx;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  p.extra = (const float*)extra;
  p.recs = (float*)recs;
  p.partial = (float*)partial;
  p.pmask = (unsigned long long*)pmask;
  p.pscal64 = (double*)pscal;
  p.g_tab = (float*)g_tab;
  p.g_scal = (float*)g_scal;
  p.loss = (float*)loss;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  p.nch = nch;
  p.rw = rw;
  p.dt = dt;
  p.nsub = p_tile / kBlockPix;
  p.loss_kind = loss_kind;
  p.lscale = LOSS ? lscale : 0.0f;
  if (p_tile % kBlockPix || dt % 4 || ((uintptr_t)tab & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = stream_passes(p) > 1
                      ? stream_launch<LOSS, true>(p, n, st)
                      : stream_launch<LOSS, false>(p, n, st);
  if (e != cudaSuccess) return (int)e;
  const size_t cells = (size_t)rw * (kGeo + tex_d);
  stream_chunk_reduce<<<dim3((unsigned)((cells + 255) / 256), n), 256, 0,
                        st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stream_scal_reduce<<<n, 64, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The kernels' shapes at (dt, tex_d, agg_kind, s_agg): out[0] B2's warps
// per block, out[1] its resident blocks per SM (the occupancy API), out[2]
// its dynamic shared memory in bytes; out[3..5] the same of B1's kernel;
// out[6] the floats of a pixel's record (the records' buffer holds N nt
// p_tile of them).
template <bool LOSS, bool MULTI>
static int stream_occupancy(const Params& p, int* out) {
  size_t shape[3];
  cudaError_t e = stream_shapes<LOSS, MULTI>(p, shape);
  if (e != cudaSuccess) return (int)e;
  int b2 = 0, b1 = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b2, stream_adjoint_kernel<LOSS, MULTI>, (int)shape[0] * 32, shape[1]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b1, stream_replay_kernel<LOSS, MULTI>, kStreamWarps * 32, shape[2]);
  out[0] = (int)shape[0];
  out[1] = b2;
  out[2] = (int)shape[1];
  out[3] = kStreamWarps;
  out[4] = b1;
  out[5] = (int)shape[2];
  out[6] = rec_floats(p);
  return (int)e;
}

template <bool LOSS>
static int stream_grads_occupancy(int dt, int tex_d, int agg_kind, int s_agg,
                                  int* out) {
  Params p = {};
  p.dt = dt;
  p.tex_d = tex_d;
  p.agg_kind = agg_kind;
  p.s_agg = s_agg;
  return stream_passes(p) > 1 ? stream_occupancy<LOSS, true>(p, out)
                              : stream_occupancy<LOSS, false>(p, out);
}
#endif

}  // namespace ptf
