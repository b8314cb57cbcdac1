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
// plane in registers and carried it over a sequential grid. The design is
// psv_scan.cuh: one cooperative launch, bit-sliced warp masks (6 ballots a
// warp), one grid sync for the carries across tiles. The payload is one
// gather per row where the row's answers are written.

#include "psv_scan.cuh"

namespace {

// B12/B13 and, with `pay`, B14
struct PsvNsv {
  static constexpr bool kLe = false;  // strict answers only
  const int* d;
  int* psv;
  int* nsv;
  const int* pay;  // null: no payload
  int* psv_pay;
  int* nsv_pay;
  __device__ int delta(int i) const { return d[i]; }
  __device__ void write(int i, int, int p, int n) const {
    psv[i] = p;
    nsv[i] = n;
    if (pay) {
      psv_pay[i] = p >= 0 ? pay[p >> 6] : -1;
      nsv_pay[i] = n != psv::kBig ? pay[n >> 6] : -1;
    }
  }
};

}  // namespace

// agg: the scratch of psv_scan.cuh (threshold_core.scan_scratch); clk: null,
// or 5 int64 a block for the phase clocks (psv_scan.cuh)
extern "C" int tbvh_psv_nsv(const int* dlt, int m, int* agg, int* psv, int* nsv, long long* clk,
                            cudaStream_t stream) {
  return (int)psv::launch(PsvNsv{dlt, psv, nsv, nullptr, nullptr, nullptr}, m, agg, psv, nsv,
                          clk, stream);
}

extern "C" int tbvh_psv_nsv_payload(const int* dlt, const int* pay, int m, int* agg, int* psv,
                                    int* psv_pay, int* nsv, int* nsv_pay, cudaStream_t stream) {
  return (int)psv::launch(PsvNsv{dlt, psv, nsv, pay, psv_pay, nsv_pay}, m, agg, psv, nsv,
                          nullptr, stream);
}

// The grid a call over m rows launches: {blocks, most tiles a block, blocks
// an SM, SMs}
extern "C" int tbvh_psv_nsv_grid(int m, int* out) {
  return (int)psv::grid_of<PsvNsv>(m, out);
}
