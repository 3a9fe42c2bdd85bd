// K5 in the generic form (rollout_generic.cuh), a source of its own so that
// nvcc compiles it in parallel with K2 and K3 (rollout_generic.cu);
// rollout_generic.cu's rollout_generic_entry calls rollout_generic_traj.
#include "rollout_generic.cuh"

namespace tfmpc {

int rollout_generic_traj(const RolloutCall& c) {
  return rollout_generic_kinds<KindList<kTraj>>(c);
}

}  // namespace tfmpc
