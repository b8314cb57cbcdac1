// Packed previous/next-smaller-value scans (B12/B13) and the same with a
// payload read at the answers (B14).
//
// Replaces the TPU kernels tpu_bvh/ops/pallas/threshold_core.py:
// psv_nsv_packed (_psv_kernel, _nsv_kernel, sublane layout),
// psv_nsv_packed_lanes (_psv_kernel_lanes, _nsv_kernel_lanes, lane layout)
// and psv_nsv_payload_auto (_psv_kernel_lanes_pay, _nsv_kernel_lanes_pay).
// The two layouts are one function on the card. Contract
// (tpu_bvh_torch/ops/threshold_core.py), for deltas d i32[m] in [0, 63]:
//   psv[i] = max_{j < i, d_j < d_i} (64 j + d_j), -1 if none;
//   nsv[i] = min_{j > i, d_j < d_i} (64 j + d_j), 2^31 - 1 if none;
//   psv_pay[i] = pay[psv[i] >> 6], nsv_pay[i] = pay[nsv[i] >> 6], -1 if none.
//
// Bound on the card: bytes, 4 B read and 8 B written per row (B14: 8 and
// 16), about 1 us at 262K rows; the TPU kernels expanded a [64, chunk]
// plane in registers and carried it over a sequential grid. The design
// (threshold_common.cuh) keeps the 64-threshold plane as 64 warp ballots,
// never in memory: one pass for block aggregates, one small block for the
// carries across blocks, one pass that answers each row from its lane's
// mask and the carries. Three launches, 16 KB of shared memory a block.
// The payload is one gather per row in the last pass.

#include "threshold_common.cuh"

extern "C" int tbvh_psv_nsv(const int* dlt, int m, int* agg, int* psv, int* nsv,
                            cudaStream_t stream) {
  return (int)thr::run<false>(dlt, m, agg, psv, nsv, nullptr, nullptr, nullptr, stream);
}

extern "C" int tbvh_psv_nsv_payload(const int* dlt, const int* pay, int m, int* agg, int* psv,
                                    int* psv_pay, int* nsv, int* nsv_pay, cudaStream_t stream) {
  return (int)thr::run<false>(dlt, m, agg, psv, nsv, pay, psv_pay, nsv_pay, stream);
}
