"""One solved scenario's trajectory, printed as a table or saved as CSV.

Counterpart of ``tfmpc_tpu/utils/trajectory.py``, with the same table and
the same CSV: a ``timestep`` index column, ``state_j``, ``action_j`` (empty
at the final step) and ``cost``, each number as numpy prints it, which is
the text that ``pandas.DataFrame.to_csv`` writes. Tensors are copied to the
host once, at construction.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Trajectory:
    """Host-side (states, actions, costs) of one solved scenario.

    ``states``: [T+1, n]; ``actions``: [T, m]; ``costs``: [T+1] (the last
    entry is the final cost); tensors or arrays. Slice a batched result
    per scenario first (``from_result(result, index)``).
    """

    def __init__(self, states, actions, costs):
        self.states = _host(states)
        self.actions = _host(actions)
        self.costs = _host(costs)
        if self.states.ndim != 2:
            raise ValueError(
                "Trajectory holds a single scenario: states must be [T+1, n], "
                f"got shape {self.states.shape}"
            )

    def __len__(self) -> int:
        return self.actions.shape[0]

    @property
    def total_cost(self) -> float:
        return float(np.sum(self.costs))

    @property
    def final_state(self) -> np.ndarray:
        return self.states[-1]

    def __repr__(self) -> str:
        T = len(self)
        lines = [f"Trajectory(T={T}, total_cost={self.total_cost:.4f})"]
        fmt = lambda v: "[" + ", ".join(f"{x: .4f}" for x in v) + "]"  # noqa: E731
        lines.append(f"{'t':>4}  {'state':<40} {'action':<40} {'cost':>12}")
        for t in range(T):
            lines.append(
                f"{t:>4}  {fmt(self.states[t]):<40} {fmt(self.actions[t]):<40} "
                f"{self.costs[t]:>12.4f}"
            )
        lines.append(
            f"{T:>4}  {fmt(self.states[T]):<40} {'(final)':<40} "
            f"{self.costs[T]:>12.4f}"
        )
        return "\n".join(lines)

    def _columns(self) -> dict:
        """The CSV's columns by name, each ``[T+1]``: the states, the
        actions (NaN at the final step, in float64 as the JAX package's
        table holds them) and the costs."""
        T = len(self)
        cols = {f"state_{j}": self.states[: T + 1, j]
                for j in range(self.states.shape[1])}
        for j in range(self.actions.shape[1]):
            col = np.full(T + 1, np.nan)
            col[:T] = self.actions[:, j]
            cols[f"action_{j}"] = col
        cols["cost"] = self.costs
        return cols

    def save(self, path: str) -> str:
        """Write the trajectory as CSV; returns the path written."""
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        cols = self._columns()
        text = [np.asarray(c).astype(str) for c in cols.values()]
        rows = [",".join(["timestep", *cols])]
        for t in range(len(self) + 1):
            cells = ("" if v == "nan" else v for v in (c[t] for c in text))
            rows.append(",".join([str(t), *cells]))
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
        return path

    @classmethod
    def from_result(cls, result, index: Optional[int] = None) -> "Trajectory":
        """Wrap a solver result (an LQR tuple or an ``ILQRResult``: its
        states, actions and costs), optionally one scenario of a batch."""
        states, actions, costs = result[0], result[1], result[2]
        if index is not None:
            states, actions, costs = states[index], actions[index], costs[index]
        return cls(states, actions, costs)
