"""Checkpoint and resume of batched solves.

Counterpart of ``tfmpc_tpu/utils/checkpoint.py``, in the same file format,
so a checkpoint written by either package resumes in the other. The unit
is ``ilqr_batched.SolverState``, saved as a flat ``.npz``: its nine arrays
under their field names, a metadata record ``__tfmpc_meta__`` ``[format,
B, T, n, m]`` (format 1) and the trajectory's dtype under ``__dtype__``.

Usage::

    result = ilqr.solve_batch(env, x0, horizon=100, config=cfg_3_iters)
    save_state("ckpt.npz", state_from_result(result))
    ...
    state = load_state("ckpt.npz")
    result = ilqr_batched.resume(env, state, config=cfg_full)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tfmpc_tpu_torch.interop import state_from_numpy
from tfmpc_tpu_torch.solvers.ilqr_batched import SolverState, _validate_state

_META_KEY = "__tfmpc_meta__"
_FORMAT = 1


def save_state(path: str, state: SolverState) -> str:
    """Write a ``SolverState`` to ``.npz`` with its metadata record; returns
    the path written."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in state._asdict().items()}
    B, Tp1, n = arrays["X"].shape
    arrays[_META_KEY] = np.array(
        [_FORMAT, B, Tp1 - 1, n, arrays["U"].shape[-1]], dtype=np.int64
    )
    arrays["__dtype__"] = np.array(str(arrays["X"].dtype))
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load_state(path: str, *, device="cuda") -> SolverState:
    """Read a ``SolverState`` written by ``save_state`` (of either package)
    onto ``device`` (the card unless ``device="cpu"`` is passed).

    Raises for a missing field, a format newer than this one, a dtype or
    shapes that disagree with the metadata, and fields whose batch axis or
    horizon disagree.
    """
    with np.load(path) as data:
        missing = [k for k in SolverState._fields if k not in data.files]
        if missing:
            raise ValueError(
                f"{path} is not a solver checkpoint: missing fields {missing}"
            )
        arrays = {k: data[k] for k in SolverState._fields}
        X, U = arrays["X"], arrays["U"]
        if "__dtype__" in data.files:
            recorded = str(data["__dtype__"])
            if str(X.dtype) != recorded:
                raise ValueError(
                    f"{path}: X dtype {X.dtype} disagrees with the recorded "
                    f"checkpoint dtype {recorded}; file corrupt?"
                )
        if _META_KEY in data.files:
            fmt, B, T, n, m = (int(v) for v in data[_META_KEY])
            if fmt > _FORMAT:
                raise ValueError(
                    f"{path}: checkpoint format {fmt} is newer than this "
                    f"build supports ({_FORMAT})"
                )
            if X.shape != (B, T + 1, n) or U.shape != (B, T, m):
                raise ValueError(
                    f"{path}: array shapes {X.shape}/{U.shape} disagree "
                    f"with the checkpoint metadata (B={B}, T={T}, n={n}, "
                    f"m={m}); file corrupt?"
                )
    B = X.shape[0]
    bad = [k for k, v in arrays.items() if v.shape[0] != B]
    if bad or X.shape[1] != U.shape[1] + 1:
        raise ValueError(
            f"{path}: inconsistent solver state (batch-axis mismatch on "
            f"{bad or 'X/U horizon'})"
        )
    return state_from_numpy(arrays, device=device)


def validate_state(state: SolverState, env) -> None:
    """Raise with a clear message if ``state`` cannot resume on ``env``
    (other state or action sizes, or a dtype other than the env's
    parameters'): the check ``ilqr_batched.resume`` runs."""
    _validate_state(state, env)
