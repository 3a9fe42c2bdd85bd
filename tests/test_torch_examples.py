"""The port's examples (``examples/torch_*.py``) run end to end on the CPU.

Each runs in-process with ``--device cpu``, as ``tests/test_examples.py``
runs the JAX package's, and must print the line its JAX twin's test looks
for; an API drift (a renamed function, a changed signature) fails here
instead of in a user's shell.
"""

import io
import os
import runpy
import sys
from contextlib import redirect_stdout

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,expect", [
    ("torch_custom_env.py", ["batched solve", "use_pallas=False"]),
    ("torch_mpc_closed_loop.py", ["closed-loop final state: [8.000, -5.000]"]),
    ("torch_distributed_solve.py", ["device(s)",
                                    "128 scenarios over 1 device(s)",
                                    "combined data x time (1x1): 128 of "
                                    "128 converged"]),
    ("torch_checkpoint_resume.py", [
        "resumed to convergence",
        "max control deviation vs uninterrupted solve: 0.0e+00"]),
])
def test_example_runs(name, expect, monkeypatch):
    path = os.path.join(EXAMPLES, name)
    monkeypatch.setattr(sys, "argv", [path, "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    out = buf.getvalue()
    for line in expect:
        assert line in out, out


def test_examples_import_no_jax():
    """The port's examples import the port only: no JAX, no JAX package."""
    for name in sorted(os.listdir(EXAMPLES)):
        if name.startswith("torch_"):
            text = open(os.path.join(EXAMPLES, name)).read()
            assert "import jax" not in text and "tfmpc_tpu." not in text \
                and "from tfmpc_tpu " not in text, name
