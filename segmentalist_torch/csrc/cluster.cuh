// What the item chains' cluster kernels share (K10, item_chain.cuh; K11,
// fullcov_item_chain.cu): one chain on one thread-block cluster of C CTAs,
// each the owner of a share of the K columns, that merge one draw a step
// through distributed shared memory.
//
// - The draw's entry: (score_key, 2 k + occupied, first empty column) as a
//   uint4.  publish() puts an entry into a slot of every CTA of the cluster
//   (lane l < C writes CTA l's); after one cluster barrier (sync()) every
//   CTA merges the same slots (merge_slots) into the same k_new: a total
//   order (the larger key, then the lower index; the least first empty),
//   so the draw does not depend on C.
// - launch(): cudaLaunchKernelEx with the cluster's dimension (sizes above
//   8 need cudaFuncAttributeNonPortableClusterSizeAllowed).
// - max_cluster(): the largest cluster the card schedules for a set of
//   instantiations at their block sizes.
#pragma once

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "diag_family_chain.cuh"

namespace cluster {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;

// Every thread of the cluster arrives (release) and waits (acquire): the
// writes before it, remote ones too, are seen after it.
__device__ __forceinline__ void sync() {
    asm volatile(
        "barrier.cluster.arrive.release;\n\t"
        "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint4 entry(unsigned key, int i, int e) {
    return make_uint4(key, (unsigned)i, (unsigned)e, 0u);
}

// The entry into slot `slot` (an address of this CTA's shared memory) of
// every CTA of the cluster: lane l < C writes CTA l's.
__device__ __forceinline__ void publish(cg::cluster_group &cl, uint4 *slot,
                                        uint4 e, int C, int lane) {
    if (lane < C) *cl.map_shared_rank(slot, lane) = e;
}

// The n entries of `slots` merged on a warp: every lane returns the best
// key, its lowest index and the least first empty (K where none).
__device__ __forceinline__ void merge_slots(const uint4 *slots, int n, int K,
                                            unsigned &key, int &i, int &e) {
    const int lane = threadIdx.x & 31;
    key = 0u;
    i = INT_MAX;
    e = K;
    for (int j = lane; j < n; j += 32) {
        const uint4 s = slots[j];
        if (s.x > key || (s.x == key && (int)s.y < i)) {
            key = s.x;
            i = (int)s.y;
        }
        e = min(e, (int)s.z);
    }
    diag_family_chain::warp_reduce(key, i, e);
}

// k_new from a merged entry: the drawn column if occupied, else the first
// empty one (else K - 1); column 0 where nothing was drawn.
__device__ __forceinline__ int draw(int i, int e, int K) {
    return i == INT_MAX ? 0 : (i & 1) ? i >> 1 : (e < K ? e : K - 1);
}

template <class Kern, class A>
cudaError_t launch(Kern kern, const A &a, int C, int threads, int smem,
                   cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && C > 8)
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, a);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// An instantiation with its block size.
struct Inst {
    const void *fn;
    int threads;
};

// The largest cluster the card schedules for every instantiation at its
// block size and `smem` bytes of dynamic shared memory: kMaxCluster
// (non-portable) where cudaOccupancyMaxActiveClusters says so, else 8, the
// portable size (or minus a CUDA error code).
inline int max_cluster(const Inst *inst, int n, int smem) {
    for (int j = 0; j < n; ++j) {
        const Inst &in = inst[j];
        cudaError_t err = cudaFuncSetAttribute(
            in.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = kMaxCluster;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(kMaxCluster);
        cfg.blockDim = dim3(in.threads);
        cfg.dynamicSmemBytes = smem;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveClusters(&clusters, in.fn, &cfg);
        if (err != cudaSuccess) {
            cudaGetLastError();
            return -(int)err;
        }
        if (clusters < 1) return 8;
    }
    return kMaxCluster;
}

}  // namespace cluster
