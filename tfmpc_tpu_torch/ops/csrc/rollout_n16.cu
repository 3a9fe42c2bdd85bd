// K2, K3 and K5 with the HVAC step at n = m = 16 (rollout.cuh), a source
// of its own so that nvcc compiles it in parallel with the other dims;
// rollout.cu's rollout_entry calls rollout_n16.
#include "rollout.cuh"

namespace tfmpc {

int rollout_n16(const RolloutCall& c) {
  return rollout_dims<DimList<16>, StepKinds>(c);
}

}  // namespace tfmpc
