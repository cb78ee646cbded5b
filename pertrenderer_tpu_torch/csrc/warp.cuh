// The warp type of the kernels that spread a pixel's rows or channels
// across the 32 lanes of a warp (K12: binned_warp.cuh; K6 / K7:
// stream_warp.cuh; K8c: perturbed.cu), and their butterflies.
//
// The per-pixel functions take the warp type Wp as a template parameter:
// it gives the lane and the warp primitives (shfl_xor, shfl_up,
// shfl_down, shfl, ballot, sync).  CardWarp is the card's; the CPU tests
// compile the same functions with a host warp whose 32 lanes are fibers
// (tests/test_torch_kernel_host.py), so each butterfly below runs in the
// same order on both.
#pragma once

#include <math.h>
#include <stdint.h>

// Phase clocks for tuning (a build with -DPT_PROFILE): cycles per phase
// summed over a kernel's warps, lane 0's clock64, in the including
// translation unit's own pt_prof (read through its C entry:
// pt_binned_profile, pt_stream_profile, pt_stream_forward_profile,
// pt_k8c_profile, pt_grads_profile).  Without the
// flag the marks compile to nothing.
#ifdef PT_PROFILE
static __device__ unsigned long long pt_prof[16];
#endif
#if defined(PT_PROFILE) && defined(__CUDA_ARCH__)
#define PT_MARK(t) long long t = clock64()
#define PT_PHASE(i, t)                                                   \
  do {                                                                   \
    const long long now_ = clock64();                                    \
    if (w.lane == 0) atomicAdd(&pt_prof[i], (unsigned long long)(now_ - t)); \
    t = now_;                                                            \
  } while (0)
// The same mark where the lane is `lane` (code without a warp object).
#define PT_PHASE_AT(i, t, lane)                                          \
  do {                                                                   \
    const long long now_ = clock64();                                    \
    if ((lane) == 0)                                                     \
      atomicAdd(&pt_prof[i], (unsigned long long)(now_ - t));            \
    t = now_;                                                            \
  } while (0)
#else
#define PT_MARK(t)
#define PT_PHASE(i, t)
#define PT_PHASE_AT(i, t, lane)
#endif

namespace ptw {

__device__ __forceinline__ int pt_popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Index of the lowest set bit of a non-zero mask.
__device__ __forceinline__ int pt_ffs(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// An integer add into shared memory by several lanes (exact in any order).
__device__ __forceinline__ void pt_atomic_add(int* a, int v) {
#ifdef __CUDA_ARCH__
  atomicAdd(a, v);
#else
  *a += v;
#endif
}

// Lanes with `flag` append `val` to list[base ...] in lane order; returns
// how many did (every lane).
template <class Wp>
__device__ __forceinline__ int warp_append(Wp& w, bool flag, int val,
                                           int* list, int base) {
  const unsigned m = w.ballot(flag);
  if (flag) list[base + pt_popc(m & ((1u << w.lane) - 1u))] = val;
  return pt_popc(m);
}

template <class Wp, class T>
__device__ __forceinline__ T wsum(Wp& w, T v) {
  for (int o = 16; o > 0; o >>= 1) v += w.shfl_xor(v, o);
  return v;
}

template <class Wp, class T>
__device__ __forceinline__ T wmax(Wp& w, T v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, w.shfl_xor(v, o));
  return v;
}

template <class Wp>
__device__ __forceinline__ int wmin(Wp& w, int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, w.shfl_xor(v, o));
  return v;
}

template <class Wp>
__device__ __forceinline__ double wprod(Wp& w, double v) {
  for (int o = 16; o > 0; o >>= 1) v *= w.shfl_xor(v, o);
  return v;
}

// Inclusive product scans over the lanes, from lane 0 up (fwd) or from
// lane 31 down.
template <class Wp>
__device__ __forceinline__ double wscan_mul(Wp& w, double v, bool fwd) {
  for (int d = 1; d < 32; d <<= 1) {
    const double u = fwd ? w.shfl_up(v, d) : w.shfl_down(v, d);
    if (fwd ? w.lane >= d : w.lane + d < 32) v = u * v;
  }
  return v;
}

#ifdef __CUDACC__
struct CardWarp {
  int lane;
  template <class T>
  __device__ T shfl_xor(T v, int o) {
    return __shfl_xor_sync(0xffffffffu, v, o);
  }
  template <class T>
  __device__ T shfl_up(T v, int d) {
    return __shfl_up_sync(0xffffffffu, v, d);
  }
  template <class T>
  __device__ T shfl_down(T v, int d) {
    return __shfl_down_sync(0xffffffffu, v, d);
  }
  template <class T>
  __device__ T shfl(T v, int s) {
    return __shfl_sync(0xffffffffu, v, s);
  }
  __device__ unsigned ballot(bool x) {
    return __ballot_sync(0xffffffffu, x);
  }
  __device__ void sync() { __syncwarp(); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// An mbarrier in shared memory that one thread arms for a bulk copy.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: `bytes` from src into dst, completing bar's current phase.
// The proxy fence orders the block's earlier accesses to dst (behind the
// caller's barrier) before the asynchronous copy's writes.
__device__ __forceinline__ void bulk_fetch(void* dst, const void* src,
                                           unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  bulk_load(dst, src, bytes, bar);
}

// Every thread: waits until bar's phase of parity `phase` completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred q;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
        " selp.u32 %0, 1, 0, q;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}
#endif

}  // namespace ptw
