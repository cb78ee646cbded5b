// K3's warp pipeline (fused_forward.cu): the flat forward render, a group
// of kGroup lanes per pixel (8 for the cube's 16 slots: 4 pixels a warp),
// a warp's noise draws packed across its 32 lanes.
//
// The arithmetic of every value is pixel_forward's (fused_common.cuh),
// which stays the per-pixel reference; what changes is which draws are
// made and which lane makes them.
//
//   det1       lane g of a pixel's group takes the Box-Muller pairs u = g
//              + k kGroup, each the slots u and u + f_pad / 2: geometry
//              where the slot's bounding box, grown by the blur band,
//              holds the pixel (face_near; elsewhere it is no candidate),
//              from the faces' pixel-independent terms in shared memory
//              (FaceConst: face_geometry's values), texel and Phong only
//              for candidates (a slot that is not one has weight 0 and
//              colour +-0; its blend term is +-0, which leaves a sum that
//              starts at +0 unchanged);
//   coverage   a candidate outside the band |d| <= fl(|sigma| B) takes S
//              hits or none without a draw (cover_certain).  The (lane,
//              pair) entries with a row in the band (Cauchy: per row) are
//              listed in the warp's shared scratch and their (entry,
//              sample) draws spread over the 32 lanes; a hit adds 1 to the
//              row's integer count (exact in any order);
//   det2       each lane's z_map rows as pixel_forward (z_max a max over
//              the group; the division and the log only where they can
//              matter: a slot that is not a candidate has z_inv +-0, whose
//              sign no max with eps_bg > 0, the estimators' eps, sees, and
//              log(0) is -inf either way), into the pixel's rows in shared
//              memory;
//   aggregation the group's lane 0 over the pixel's C rows.  MC: only rows
//              with fl(z_r + gb) >= lim may win (agg_may_win); a pixel
//              with one such row takes its one-hot, S / S, without a draw;
//              the others list their rows (paired Box-Muller rows
//              adjacent) and each (pixel, sample) item goes to one lane of
//              the warp, which draws the pixel's rows for that sample,
//              takes their max and counts every row at it;
//   blend      lane 0 over the slots in order, as pixel_forward.
//
// So every count, hence the image and (EXT) the weights, has the bits of
// pixel_forward: an undrawn row's outcome is the one every draw gives it,
// and every sum and product runs in pixel_forward's order.  The warp type
// Wp is a template parameter (warp.cuh), so the host tests run these
// functions with the lanes emulated.
#pragma once

#include "fused_common.cuh"
#include "warp.cuh"

namespace ptf {

// The phase clock of a -DPT_PROFILE build, handed to the helpers.
#if defined(PT_PROFILE) && defined(__CUDA_ARCH__)
#define PT_CLK_PARAM , long long& clk
#define PT_CLK_ARG , clk
#else
#define PT_CLK_PARAM
#define PT_CLK_ARG
#endif

// A pixel's slots spread over a group of kGroup lanes: lane g of the group
// holds the units u = g + k kGroup (k < kUnits) of the pixel's f_pad / 2
// Box-Muller pairs, each the slots u and u + f_pad / 2; a warp holds 32 /
// kGroup pixels.
template <int MAXF>
PT_HOST_HD constexpr int kGroup() {
  return MAXF / 2 < 32 ? MAXF / 2 : 32;
}

template <int MAXF>
PT_HOST_HD constexpr int kUnits() {
  return (MAXF / 2 + kGroup<MAXF>() - 1) / kGroup<MAXF>();
}

// Warps per block of K3 and K11a, and the block's pixels: kGroup lanes a
// pixel.
constexpr int kFlatWarps = 8;

template <int MAXF>
PT_HOST_HD constexpr int block_pixels() {
  return kFlatWarps * (32 / kGroup<MAXF>());
}

// Entries of a warp's list: coverage entries (a lane's at most 2 kUnits)
// and the uncertain pixels' aggregation rows (each of the warp's pixels
// at most MAXF + 8).
template <int MAXF>
PT_HOST_HD constexpr int flat_list() {
  constexpr int cover = 64 * kUnits<MAXF>();
  constexpr int agg = 32 / kGroup<MAXF>() * (MAXF + 8);
  return ((cover > agg ? cover : agg) + 31) / 32 * 32;
}

// Per pixel of a warp, in shared memory: its z_map rows and weights
// (MAXF + 8 each), and its slots' coverage and colours (MAXF and 3 MAXF).
template <int MAXF>
PT_HOST_HD constexpr int flat_pixel_words() {
  return 2 * (MAXF + 8) + 4 * MAXF;
}

// A warp's scratch in shared memory, 4-byte words: each entry's code, its
// two values and two hit counts, per listed pixel its offset, row count
// and position, then its pixels' rows.
template <int MAXF>
PT_HOST_HD constexpr int flat_scratch_words() {
  return 5 * flat_list<MAXF>() + 3 * 32 +
         32 / kGroup<MAXF>() * flat_pixel_words<MAXF>();
}

struct FlatScratch {
  int* code;
  float *v0, *v1;
  int* hits;          // 2 per entry, zero between uses
  int *off, *cnt, *pos;
  float* px;          // the pixels' rows
};

template <int MAXF>
PT_HD FlatScratch flat_scratch(int* base) {
  constexpr int L = flat_list<MAXF>();
  FlatScratch S;
  S.code = base;
  S.v0 = (float*)(base + L);
  S.v1 = (float*)(base + 2 * L);
  S.hits = base + 3 * L;
  S.off = base + 5 * L;
  S.cnt = S.off + 32;
  S.pos = S.cnt + 32;
  S.px = (float*)(S.pos + 32);
  return S;
}

// Per lane, of the counting launch: pixels of active tiles, those that
// drew nothing, the noise units (Box-Muller pairs; Cauchy draws) the
// per-pixel pipeline draws there (full) and those drawn (drawn), the
// (slot, pixel) pairs whose geometry ran (face_near), and the candidates
// with a non-zero weight (their colour reaches the image).
struct FlatCounts {
  unsigned long long pixels, certain, cover_full, cover_drawn, agg_full,
      agg_drawn, near, weighted;
};

// Exclusive prefix sum of v over the lanes.
template <class Wp>
PT_HD int wscan_excl(Wp& w, int v) {
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = w.shfl_up(x, d);
    if (w.lane >= d) x += y;
  }
  return x - v;
}

// Noise unit u of a `rows`-row block for sample s: gaussian, the pair of
// rows u (lo) and u + rows / 2 (hi); cauchy, row u alone (lo).
PT_HD void unit_noise(int noise, uint32_t s0, uint32_t s1, int s, int u,
                      uint32_t pos, float* lo, float* hi) {
  const uint32_t x = ptt::hash_words(s0, s1, s, u, pos);
  if (noise == kGaussian) {
    ptt::gaussian_pair(x, lo, hi);
  } else {
    *lo = ptt::cauchy_draw(x);
    *hi = 0.0f;
  }
}

// The MC coverage of the lane's slots (row k: the slot u of its k-th
// pair, row KU + k: the slot u + F / 2), prob = count / S * maskf written
// over dist[] (pixel_forward's
// coverage), the draws in the band packed across the warp: one entry per
// Box-Muller pair with a row in the band (Cauchy: per row).  act: the
// lane's pixel is in an active tile.  Returns whether the lane drew.
template <int MAXF, class Wp>
PT_HD bool flat_coverage(const Params& p, float sigma, int b, uint32_t pos,
                         bool act, int g, Wp& w, const FlatScratch& S,
                         float dist[2 * kUnits<MAXF>()],
                         const float mk[2 * kUnits<MAXF>()],
                         FlatCounts& dc PT_CLK_PARAM) {
  constexpr int G = kGroup<MAXF>(), KU = kUnits<MAXF>();
  const int U = p.f_pad / 2, noise = p.rast_noise;
  const bool gauss = noise == kGaussian;
  const float sb = fabsf(sigma) * noise_bound(noise);
  const float inv_s = 1.0f / (float)p.s_rast;
  const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
  const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
  const unsigned lt = (1u << w.lane) - 1u;
  S.pos[w.lane] = (int)pos;
  // Entry slots of the lane: gaussian one per pair k, Cauchy one per row.
  constexpr int KE = 2 * KU;
  int slot[KE];
  int ne = 0;
  bool drew = false;
  for (int q = 0; q < KE; ++q) {
    const int k = q % KU, t = q / KU;       // pair k; Cauchy: its row t
    slot[q] = -1;
    if (gauss && t == 1) continue;
    const int u = g + k * G;
    int flags = 0;
    float dv[2] = {0.0f, 0.0f};
    for (int r = 0; act && u < U && r < 2; ++r) {
      if (!gauss && r != t) continue;
      const int j = k + r * KU;             // the lane's row (lo, hi)
      const int f = gauss ? r : 0;          // its half of the unit's noise
      int cnt = 0;
      if (mk[j] != 0.0f) {
        const int c = cover_certain(dist[j], sb);
        if (c == 0) {
          flags |= 1 << f;
          dv[f] = dist[j];
          continue;
        }
        cnt = c > 0 ? p.s_rast : 0;
      }
      dist[j] = (float)cnt * inv_s * mk[j];
    }
    const unsigned m = w.ballot(flags != 0);
    if (flags) {
      const int e = ne + ptw::pt_popc(m & lt);
      // The unit's hash row: the pair (gaussian) or the slot (Cauchy).
      const int hr = gauss ? u : u + t * U;
      S.code[e] = (hr << 7) | (flags << 5) | w.lane;
      S.v0[e] = dv[0];
      S.v1[e] = dv[1];
      slot[q] = e;
      dc.cover_drawn += (unsigned long long)p.s_rast;
      drew = true;
    }
    ne += ptw::pt_popc(m);
  }
  if (ne == 0) return false;
  w.sync();
  PT_PHASE(1, clk);
  // Draw j: entry j % ne, sample j / ne.
  const int total = ne * p.s_rast;
  for (int j0 = 0; j0 < total; j0 += 32) {
    const int j = j0 + w.lane;
    if (j < total) {
      const int e = j % ne, s = j / ne, code = S.code[e];
      float lo, hi;
      unit_noise(noise, s0, s1, s, code >> 7, (uint32_t)S.pos[code & 31],
                 &lo, &hi);
      if ((code & 32) && -S.v0[e] + sigma * lo >= 0.0f)
        ptw::pt_atomic_add(&S.hits[2 * e], 1);
      if ((code & 64) && -S.v1[e] + sigma * hi >= 0.0f)
        ptw::pt_atomic_add(&S.hits[2 * e + 1], 1);
    }
  }
  w.sync();
  PT_PHASE(2, clk);
  for (int q = 0; q < KE; ++q) {
    const int e = slot[q];
    if (e < 0) continue;
    const int code = S.code[e];
    for (int r = 0; r < 2; ++r) {
      if (!(code & (32 << r))) continue;
      const int j = q % KU + (gauss ? r : q / KU) * KU;
      dist[j] = (float)S.hits[2 * e + r] * inv_s * mk[j];
      S.hits[2 * e + r] = 0;
    }
  }
  w.sync();
  return drew;
}

// Sum over the lanes of a kGroup-lane group.
template <int G, class Wp>
PT_HD int group_sum(Wp& w, int v) {
  for (int o = G / 2; o > 0; o >>= 1) v += w.shfl_xor(v, o);
  return v;
}

// Max over the lanes of a kGroup-lane group.
template <int G, class Wp>
PT_HD float group_max(Wp& w, float v) {
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, w.shfl_xor(v, o));
  return v;
}

// The MC aggregation's weights ws of a pixel's C z_map rows zs (both in
// shared memory; pixel_forward's sample means), lane g of its group
// taking the aggregation's noise units h = g + k kGroup (each the rows h
// and h + C / 2; Cauchy: the row h).  lim is a max over the group, the
// rows that may win are counted over it; a pixel with one takes its
// one-hot, the others list their rows (a lane's in unit order, so a pair's
// rows sit side by side; a pixel's lanes one after another) and each
// (pixel, sample) item goes to one lane of the warp, which draws the
// pixel's rows for that sample, takes their max and counts every row at
// it.  act: the pixel is in an active tile.  Returns whether it drew.
template <int MAXF, class Wp>
PT_HD bool flat_mc_agg(const Params& p, float gamma, int b, uint32_t pos,
                       bool act, int g, bool lead, Wp& w,
                       const FlatScratch& S, const float* zs, float* ws,
                       FlatCounts& dc PT_CLK_PARAM) {
  constexpr int G = kGroup<MAXF>(), KH = (MAXF + 8 + G - 1) / G;
  const int C = p.c_zpad, noise = p.agg_noise, half = C / 2;
  const bool gauss = noise == kGaussian;
  const int units = gauss ? half : C, per = gauss ? 2 : 1;
  const float gb = fabsf(gamma) * noise_bound(noise);
  const float inv_s = 1.0f / (float)p.s_agg;
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  const unsigned lt = (1u << w.lane) - 1u;
  float lm = -INFINITY;
  for (int k = 0; act && k < KH; ++k) {
    const int h = g + k * G;
    for (int t = 0; h < units && t < per; ++t)
      lm = fmaxf(lm, zs[h + t * half] - gb);
  }
  const float lim = group_max<G>(w, lm);
  int mine = 0, only = 0, used = 0;
  for (int k = 0; act && k < KH; ++k) {
    const int h = g + k * G;
    bool any = false;
    for (int t = 0; h < units && t < per; ++t) {
      const int r = h + t * half;
      ws[r] = 0.0f;
      if (agg_may_win(zs[r], gb, lim)) {
        ++mine;
        only = r;
        any = true;
      }
    }
    used += any ? 1 : 0;
  }
  const int nd = group_sum<G>(w, mine);
  if (act && nd == 1 && mine == 1) ws[only] = (float)p.s_agg * inv_s;
  if (act && lead) dc.agg_full += (unsigned long long)p.s_agg * units;
  const bool pend = act && nd > 1;
  // The list: each pending pixel's rows, its lanes one after another.
  const int excl = wscan_excl(w, pend ? mine : 0);
  const unsigned pm = w.ballot(pend && lead);
  const int nt = ptw::pt_popc(pm);
  if (pend) {
    if (lead) {
      const int u = ptw::pt_popc(pm & lt);
      S.off[u] = excl;
      S.cnt[u] = nd;
      S.pos[u] = (int)pos;
    }
    int e = excl;
    for (int k = 0; k < KH; ++k) {
      const int h = g + k * G;
      for (int t = 0; h < units && t < per; ++t) {
        const int r = h + t * half;
        if (!agg_may_win(zs[r], gb, lim)) continue;
        S.code[e] = r;
        S.v0[e] = zs[r];
        ++e;
      }
    }
    dc.agg_drawn += (unsigned long long)p.s_agg * used;
  }
  w.sync();
  PT_PHASE(1, clk);
  // Item j: listed pixel j % nt, sample j / nt.
  const int total = nt * p.s_agg;
  for (int j0 = 0; j0 < total; j0 += 32) {
    const int j = j0 + w.lane;
    if (j < total) {
      const int u = j % nt, s = j / nt;
      const int o = S.off[u], n = S.cnt[u];
      const uint32_t at = (uint32_t)S.pos[u];
      float pv[MAXF + 8];
      float mx = -INFINITY, lo = 0.0f, hi = 0.0f;
      int last = -1;
      for (int k = 0; k < n; ++k) {
        const int r = S.code[o + k];
        const int h = gauss && r >= half ? r - half : r;
        if (h != last) unit_noise(noise, a0, a1, s, h, at, &lo, &hi);
        last = h;
        pv[k] = S.v0[o + k] + gamma * (gauss && r >= half ? hi : lo);
        mx = fmaxf(mx, pv[k]);
      }
      for (int k = 0; k < n; ++k)
        if (pv[k] >= mx) ptw::pt_atomic_add(&S.hits[o + k], 1);
    }
  }
  w.sync();
  PT_PHASE(3, clk);
  for (int k = 0; pend && k < mine; ++k) {
    ws[S.code[excl + k]] = (float)S.hits[excl + k] * inv_s;
    S.hits[excl + k] = 0;
  }
  w.sync();
  return pend;
}

// The soft / affine / hard coverage of one slot (coverage()'s).
PT_HD float det_prob(const Params& p, float sigma, float d, float m) {
  const float x = -d / sigma;
  float pr;
  if (p.rast_kind == kRastSoft) {
    pr = 1.0f / (1.0f + expf(-x));
  } else if (p.rast_kind == kRastAffine) {
    pr = fmaxf(x > 0.5f ? 1.0f : x + 0.5f, 0.0f);
  } else {
    pr = -d >= 0.0f ? 1.0f : 0.0f;
  }
  return pr * m;
}

// K3 at row-major pixel `pix` of batch element b, lane g of the pixel's
// group (live: the pixel is in the image; every lane of the warp calls
// it): RGBA into out[0..3] on the group's lane 0, and under EXT the
// weights into w_out, as pixel_forward<MAXF, float, EXT>.  The lanes
// share det1, the coverage and z_map's rows; the group's lane 0 (the
// leader) runs the aggregation over the pixel's rows in shared memory
// (its draws packed across the warp) and the blend.  Phases of a
// -DPT_PROFILE build: 0 det1, 1 the certainty tests, the lists and
// z_map, 2 coverage draws, 3 aggregation draws, 4 the blend and the rest.
template <int MAXF, bool EXT, class Wp>
PT_HD void warp_flat_forward(const Params& p, const Tables& T,
                             const FaceConst* fc, int b, int pix, bool live,
                             Wp& w, const FlatScratch& S, FlatCounts& dc,
                             float out[4]) {
  constexpr int G = kGroup<MAXF>(), KU = kUnits<MAXF>(), MAXC = MAXF + 8;
  const int F = p.f_pad, C = p.c_zpad, U = F / 2;
  const size_t npix = (size_t)p.image_size * p.image_size;
  const float* sc = T.sc;
  const uint32_t pos = (uint32_t)pix;
  const int g = w.lane % G, q = w.lane / G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (q * G);
  float* zs = S.px + q * flat_pixel_words<MAXF>();
  float* ws = zs + MAXC;
  float* ps = ws + MAXC;
  float* cs = ps + MAXF;
  const bool act = live && pixel_active(p, b, pix);
  const bool lead = g == 0;
  PT_MARK(clk);

  // ---- det1: the lane's slots j (lo: j < KU, hi: j >= KU) ----------------
  auto slot_of = [&](int j) { return g + (j % KU) * G + (j / KU) * U; };
  auto owned = [&](int j) { return g + (j % KU) * G < U; };
  float dist[2 * KU], zz[2 * KU], mk[2 * KU], col[2 * KU][3];
  bool cand = false;
  if (act) {
    float px, py;
    pixel_center(p.image_size, pix, &px, &py);
    for (int j = 0; j < 2 * KU; ++j) {
      mk[j] = 0.0f;
      dist[j] = INFINITY;           // soft / affine / hard coverage: 0
      col[j][0] = col[j][1] = col[j][2] = 0.0f;
      const int i = slot_of(j);
      if (!owned(j) || !face_near(fc[i], px, py)) continue;
      dc.near += 1;
      float w3[3];
      face_geometry_at(p, fc[i], sc[kBlur], px, py, &dist[j], &zz[j], &mk[j],
                       w3);
      if (mk[j] != 0.0f) {
        face_shade(p, T, i, mk[j], w3, col[j]);
        cand = true;
      }
    }
  }
  PT_PHASE(0, clk);

  // ---- coverage: prob = prob_raw * maskf (kept in dist[]) ---------------
  bool drew = false;
  if (EXT) {
    if (act)
      for (int j = 0; j < 2 * KU; ++j)
        if (owned(j))
          dist[j] = p.prob_ext[((size_t)b * F + slot_of(j)) * npix + pix];
  } else if (p.rast_kind == kRastMC) {
    if (act && lead)
      dc.cover_full += (unsigned long long)p.s_rast *
                       (p.rast_noise == kGaussian ? U : F);
    if (w.ballot(cand)) {
      drew = flat_coverage<MAXF>(p, sc[kSigma], b, pos, act, g, w, S, dist,
                                 mk, dc PT_CLK_ARG);
    } else if (act) {               // no candidate: every prob is 0
      for (int j = 0; j < 2 * KU; ++j) dist[j] = 0.0f * mk[j];
    }
  } else if (act) {
    for (int j = 0; j < 2 * KU; ++j)
      dist[j] = det_prob(p, sc[kSigma], dist[j], mk[j]);
  }

  // ---- det2: z_map rows (slots, background, -inf padding) ---------------
  // A slot that is not a candidate has z_inv +-0 in pixel_forward; no max
  // with eps_bg > 0 sees its sign.
  float zinv[2 * KU];
  float zmx = -INFINITY;
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const float zden = zfar - znear;
  for (int j = 0; act && j < 2 * KU; ++j) {
    zinv[j] = mk[j] != 0.0f ? (zfar - zz[j]) / zden * mk[j] : 0.0f;
    if (owned(j)) zmx = fmaxf(zmx, zinv[j]);
  }
  const float zmax = fmaxf(group_max<G>(w, zmx), p.eps_bg);
  if (act) {
    const float gal =
        p.agg_kind == kAggHard ? 1e-6f : sc[kGamma] / sc[kAlpha];
    for (int j = 0; j < 2 * KU; ++j) {
      if (!owned(j)) continue;
      const int i = slot_of(j);
      const float pr = dist[j];
      zs[i] = gal * (pr == 0.0f ? -INFINITY : log(pr)) + zinv[j] - zmax;
      ps[i] = pr;
      for (int c = 0; c < 3; ++c) cs[i * 3 + c] = col[j][c];
    }
  }
  w.sync();
  if (act && lead) {
    for (int r = F; r < C; ++r) zs[r] = -INFINITY;
    zs[p.bg_row] = p.eps_bg - zmax;
  }
  w.sync();
  PT_PHASE(1, clk);

  // ---- aggregation weights over the C z_map rows (the leader) -------------
  if (p.agg_kind == kAggMC) {
    drew = flat_mc_agg<MAXF>(p, sc[kGamma], b, pos, act, g, lead, w, S,
                             zs, ws, dc PT_CLK_ARG) || drew;
  } else if (p.agg_kind == kAggSoft) {
    // Lane g takes the rows g + k kGroup; the max is the group's, the
    // sum adds the non-zero terms in row order (the leader), so every
    // weight has pixel_forward's bits.
    constexpr int KR = (MAXC + G - 1) / G;
    const float inv_gamma = 1.0f / sc[kGamma];
    float xs[KR], mx = -INFINITY;
    for (int k = 0; k < KR; ++k) {
      const int r = g + k * G;
      xs[k] = act && r < C ? inv_gamma * zs[r] : -INFINITY;
      mx = fmaxf(mx, xs[k]);
    }
    mx = group_max<G>(w, mx);
    float sum = 0.0f;
    for (int k = 0; k < KR; ++k) {
      const int r = g + k * G;
      const float e = xs[k] == -INFINITY ? 0.0f : exp(xs[k] - mx);
      if (act && r < C) ws[r] = e;
      unsigned m = (w.ballot(e != 0.0f) & gmask) >> (q * G);
      w.sync();
      while (lead && m) {
        const int t = ptw::pt_ffs(m);
        m &= m - 1u;
        sum += ws[t + k * G];
      }
    }
    sum = w.shfl(sum, q * G);
    for (int k = 0; k < KR; ++k) {
      const int r = g + k * G;
      if (act && r < C) ws[r] = ws[r] / sum;
    }
  } else if (act && lead) {                  // first-wins hard one-hot
    float mx = -INFINITY;
    for (int r = 0; r < C; ++r) mx = fmaxf(mx, zs[r]);
    int first = C;
    for (int r = C - 1; r >= 0; --r)
      if (zs[r] >= mx) first = r;
    for (int r = 0; r < C; ++r) ws[r] = r == first ? 1.0f : 0.0f;
  }
  const bool gdrew = (w.ballot(drew) & gmask) != 0;
  w.sync();
  if (act && lead) {
    dc.pixels += 1;
    dc.certain += gdrew ? 0 : 1;
  }
  // ---- det3: blend (an inactive tile: the background, alpha 0) ----------
  // The slots in order, only those with a weight or a coverage (a term
  // +-0 leaves a sum that starts at +0 unchanged, a factor 1 - 0 the
  // product): lo slots u = g + k kGroup, then the hi ones u + F / 2.  Every
  // lane takes part in the ballots.
  float rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f, ap = 1.0f;
  for (int j = 0; j < 2 * KU; ++j) {
    const int i = slot_of(j);
    const bool live_j =
        act && owned(j) && (ws[i] != 0.0f || ps[i] != 0.0f);
    dc.weighted += act && owned(j) && ws[i] != 0.0f && mk[j] != 0.0f;
    unsigned m = (w.ballot(live_j) & gmask) >> (q * G);
    while (lead && m) {
      const int t = ptw::pt_ffs(m);
      m &= m - 1u;
      const int k = t + (j % KU) * G + (j / KU) * U;
      rgb0 += ws[k] * cs[k * 3];
      rgb1 += ws[k] * cs[k * 3 + 1];
      rgb2 += ws[k] * cs[k * 3 + 2];
      ap = ap * (1.0f - ps[k]);
    }
  }
  if (!live) return;
  if (!act) {
    if (lead) {
      out[0] = sc[kBg];
      out[1] = sc[kBg + 1];
      out[2] = sc[kBg + 2];
      out[3] = 0.0f;
    }
    if (EXT)
      for (int r = g; r < C; r += G)
        p.w_out[((size_t)b * C + r) * npix + pix] =
            r == p.bg_row ? 1.0f : 0.0f;
    return;
  }
  if (EXT)
    for (int r = g; r < C; r += G)
      p.w_out[((size_t)b * C + r) * npix + pix] = ws[r];
  if (!lead) return;
  const float wb = ws[p.bg_row];
  out[0] = rgb0 + wb * sc[kBg + 0];
  out[1] = rgb1 + wb * sc[kBg + 1];
  out[2] = rgb2 + wb * sc[kBg + 2];
  out[3] = 1.0f - ap;
  PT_PHASE(4, clk);
}


// K11a at row-major pixel `pix` of batch element b, lane g of the pixel's
// group (live: the pixel is in the image; every lane of the warp calls
// it): this shard's coverage of the lane's slots into prob[j], the slot
// g + (j % kUnits) kGroup + (j / kUnits) f_pad / 2 where that is below
// f_pad, with pixel_prob's bits (fused_common.cuh): det1's geometry only
// where the slot's grown box holds the pixel (FaceConst), the MC coverage
// drawn only in the band, its draws packed across the warp
// (flat_coverage), the soft / affine / hard coverage per slot (det_prob);
// 0 on an inactive tile.  Phases of a -DPT_PROFILE build: 0 det1, 1 the
// certainty tests and the list, 2 the coverage draws.
template <int MAXF, class Wp>
PT_HD void warp_flat_prob(const Params& p, const FaceConst* fc,
                          const float* sc, int b, int pix, bool live, Wp& w,
                          const FlatScratch& S, FlatCounts& dc,
                          float prob[2 * kUnits<MAXF>()]) {
  constexpr int G = kGroup<MAXF>(), KU = kUnits<MAXF>();
  const int U = p.f_pad / 2;
  const int g = w.lane % G, q = w.lane / G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (q * G);
  const bool act = live && pixel_active(p, b, pix);
  PT_MARK(clk);
  float mk[2 * KU];
  bool cand = false;
  float px = 0.0f, py = 0.0f;
  if (act) pixel_center(p.image_size, pix, &px, &py);
  for (int j = 0; j < 2 * KU; ++j) {
    mk[j] = 0.0f;
    prob[j] = INFINITY;             // soft / affine / hard coverage: 0
    const int i = g + (j % KU) * G + (j / KU) * U;
    if (!act || g + (j % KU) * G >= U || !face_near(fc[i], px, py))
      continue;
    dc.near += 1;
    float z, w3[3];
    face_geometry_at(p, fc[i], sc[kBlur], px, py, &prob[j], &z, &mk[j], w3);
    cand = cand || mk[j] != 0.0f;
  }
  PT_PHASE(0, clk);
  bool drew = false;
  if (p.rast_kind == kRastMC) {
    if (act && g == 0)
      dc.cover_full += (unsigned long long)p.s_rast *
                       (p.rast_noise == kGaussian ? U : p.f_pad);
    if (w.ballot(cand)) {
      drew = flat_coverage<MAXF>(p, sc[kSigma], b, (uint32_t)pix, act, g, w,
                                 S, prob, mk, dc PT_CLK_ARG);
    } else {                        // no candidate: every prob is 0
      for (int j = 0; j < 2 * KU; ++j) prob[j] = 0.0f * mk[j];
    }
  } else {
    for (int j = 0; j < 2 * KU; ++j)
      prob[j] = det_prob(p, sc[kSigma], prob[j], mk[j]);
  }
  if (!act)
    for (int j = 0; j < 2 * KU; ++j) prob[j] = 0.0f;
  const bool gdrew = (w.ballot(drew) & gmask) != 0;
  if (act && g == 0) {
    dc.pixels += 1;
    dc.certain += gdrew ? 0 : 1;
  }
}

}  // namespace ptf
