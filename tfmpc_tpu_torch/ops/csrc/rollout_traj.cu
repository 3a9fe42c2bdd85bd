// K5 at n = m in {2, 3, 5, 6} for every env (rollout.cuh), a source of its
// own so that nvcc compiles it in parallel with K2 and K3 (rollout.cu);
// rollout.cu's rollout_entry calls rollout_traj.
#include "rollout.cuh"

namespace tfmpc {

int rollout_traj(const RolloutCall& c) {
  return rollout_dims<SmallDims, KindList<kTraj>>(c);
}

}  // namespace tfmpc
