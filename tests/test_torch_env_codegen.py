"""The step functor generated from a user env's PyTorch step.

``ops/env_codegen.py`` traces an env's public ``transition``, ``cost`` and
``final_cost`` on one scenario and emits C++ for a functor in
``csrc/envs.cuh``'s contract, which the rollout kernels compile in
(``csrc/rollout_user.cuh``), as the JAX package's ``generic_lane_functions``
traces the same three into its Pallas kernels. There is no nvcc here, so
the functor is compiled for the host with g++ (``env_codegen.host_source``:
the CUDA qualifiers defined away, and a harness that loops ``prep``,
``row``, ``stage_cost`` and ``final_cost`` over a batch) and held, on the
same seeded inputs in float64, against the port env's own step and the JAX
env's ``generic_lane_functions()`` step: within 1e-12 of the largest value
compared (the functor sums in index order, torch and XLA in their own).
Cases: the custom-env example's ``DampedChain``, a twin of
``tests/test_fuzz_envs.py``'s ``RandomSmoothEnv`` at (3, 2), (5, 5) and
(8, 3), and the public steps of navigation (two zones), HVAC-6,
reservoir-5 and a linear system at (24, 6); an env of the other supported
ops against its own step. Then the refusals (an unsupported op, a
data-dependent branch, a wrong output shape, each naming the opt-outs, and
a solve that raises instead of falling back) and that the source depends on
the graph, dims and dtype, not on the parameter values. Only the g++ cases
skip, and only where g++ is absent.
"""

import ctypes
import dataclasses
import json
import runpy
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu_torch import Bounds, Env, interop
from tfmpc_tpu_torch.models.base import USER_STEP_ID
from tfmpc_tpu_torch.models.registry import make_env
from tfmpc_tpu_torch.ops import env_codegen
from tfmpc_tpu_torch.solvers import ilqr

import test_fuzz_envs

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = runpy.run_path(str(ROOT / "examples" / "torch_custom_env.py"))
JAX_EXAMPLE = runpy.run_path(str(ROOT / "examples" / "custom_env.py"))
B = 16
TOL = 1e-12


@dataclasses.dataclass(frozen=True, eq=False)
class RandomSmoothEnv(Env):
    """The port's twin of ``test_fuzz_envs.RandomSmoothEnv``, over
    ``[..., n]`` as the port's envs are: x' = x + dt (A x + B u + s
    tanh(x)); a quadratic plus tanh cost."""

    A: torch.Tensor
    B: torch.Tensor
    s: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    q: torch.Tensor
    bounds: Optional[Bounds] = None

    @property
    def state_size(self):
        return self.A.shape[0]

    @property
    def action_size(self):
        return self.B.shape[1]

    def transition(self, x, u):
        return x + 0.1 * (x @ self.A.mT + u @ self.B.mT
                          + self.s * torch.tanh(x))

    def cost(self, x, u):
        return (((x @ self.Q) * x).sum(-1) + ((u @ self.R) * u).sum(-1)
                + (self.q * torch.tanh(x)).sum(-1))

    def final_cost(self, x):
        return 2.0 * ((x @ self.Q) * x).sum(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class OpsEnv(Env):
    """A step through the supported ops the other cases do not reach."""

    W: torch.Tensor   # [n, n]
    c: torch.Tensor   # [n]
    k: torch.Tensor   # 0-d

    @property
    def state_size(self):
        return self.W.shape[0]

    def transition(self, x, u):
        n = x.shape[-1]
        y = torch.where(x > 0.2, torch.sigmoid(x), -torch.abs(x) / 3.0)
        z = torch.maximum(x, self.c) - torch.minimum(u, 0.5 * self.c)
        w = torch.matmul(self.W, torch.clamp(x, -1.0, 1.0)) / (1.0 + x * x)
        s = torch.stack([x[0], x[1:].mean()]).sum() * self.k
        cat = torch.cat([x[1:], x[:1]])
        v = x.reshape(1, n).t().reshape(n) + x.view(1, n).expand(2, n)[1]
        f = torch.full((n,), 0.25, dtype=x.dtype) * torch.exp(-u * u)
        return (x + 0.05 * (y + z + w + cat - v + f) + 0.01 * s
                + torch.log(1.0 + u ** 2) * torch.sqrt(torch.abs(u) + 1.0))

    def cost(self, x, u):
        g = torch.relu(x - self.c).pow(3).sum() + torch.dot(u, u)
        return g + torch.sin(x).prod() + (x @ self.W).max() \
            - 1.0 / (2.0 + torch.cos(u).sum() ** 2)

    def final_cost(self, x):
        return torch.scalar_tensor(1.5, dtype=x.dtype) * (x * x).mean() \
            + torch.tanh(x).amin(dim=-1)


class Unsupported(RandomSmoothEnv):
    def transition(self, x, u):
        return x + 0.1 * torch.cumsum(u, dim=-1)


class Branchy(RandomSmoothEnv):
    def transition(self, x, u):
        if x[0] > 0:
            return x + 0.1 * u
        return x - 0.1 * u


class WideCost(RandomSmoothEnv):
    def cost(self, x, u):
        return x * x


def _fuzz_envs(seed, n, m, bounded=False):
    """The JAX fuzz env and its port twin on the same float64 values."""
    jenv32 = test_fuzz_envs._make_env(seed, n, m, bounded)
    arrays = {f.name: np.asarray(getattr(jenv32, f.name), np.float64)
              for f in dataclasses.fields(jenv32) if f.name != "bounds"}
    bounds = None
    if bounded:
        bounds = tuple(np.asarray(a, np.float64) for a in
                       (jenv32.bounds.low, jenv32.bounds.high))
    jenv = test_fuzz_envs.RandomSmoothEnv(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        bounds=None if bounds is None else test_fuzz_envs.Bounds(
            low=jnp.asarray(bounds[0]), high=jnp.asarray(bounds[1])))
    tenv = interop.user_env_from_numpy(RandomSmoothEnv, arrays, bounds,
                                       dtype=torch.float64, device="cpu")
    return jenv, tenv


def _chain(d, coupling_seed=None):
    C = (-2.0 * np.eye(d) + np.eye(d, k=1) + np.eye(d, k=-1)) * 0.3
    if coupling_seed is not None:
        C = C + 0.05 * np.random.default_rng(coupling_seed).standard_normal(
            (d, d))
    jenv = JAX_EXAMPLE["DampedChain"](coupling=jnp.asarray(C))
    tenv = interop.user_env_from_numpy(EXAMPLE["DampedChain"],
                                       {"coupling": C},
                                       dtype=torch.float64, device="cpu")
    return jenv, tenv


def _linear24x6():
    rng = np.random.default_rng(24)
    n, m = 24, 6
    L = rng.standard_normal((n, n)) / np.sqrt(n)
    return dict(name="linear", A=np.eye(n) + 0.05 * rng.standard_normal(
        (n, n)), B=0.1 * rng.standard_normal((n, m)),
        c=0.01 * rng.standard_normal(n), Q=0.5 * (L @ L.T) + 0.5 * np.eye(n),
        R=np.eye(m), N=0.01 * rng.standard_normal((n, m)),
        q=0.1 * rng.standard_normal(n), r=0.1 * rng.standard_normal(m),
        Q_f=np.eye(n), q_f=0.1 * rng.standard_normal(n))


def _registry(name, **over):
    if name == "linear":
        cfg = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in _linear24x6().items()}
    else:
        cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
        cfg.pop("x0", None)
    cfg.update(over)
    return (jax_make_env(cfg, dtype=jnp.float64),
            make_env(cfg, dtype=torch.float64, device="cpu"))


# label -> (a maker of (JAX env, port env), the inputs' range)
CASES = {
    "damped_chain": (lambda: _chain(6), (-2.0, 2.0)),
    "fuzz_3x2": (lambda: _fuzz_envs(11, 3, 2), (-1.5, 1.5)),
    "fuzz_5x5": (lambda: _fuzz_envs(22, 5, 5, True), (-1.5, 1.5)),
    "fuzz_8x3": (lambda: _fuzz_envs(88, 8, 3), (-1.5, 1.5)),
    "navigation_two_zones": (lambda: _registry("navigation"), (-2.0, 9.0)),
    "hvac6": (lambda: _registry("hvac"), (15.0, 28.0)),
    "reservoir5": (lambda: _registry("reservoir"), (0.0, 100.0)),
    "linear24x6": (lambda: _registry("linear"), (-1.0, 1.0)),
}


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile a generated functor for the host (g++) and load it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: the host build of the generated functor "
                    "cannot run")
    out = tmp_path_factory.mktemp("functors")
    built = {}

    def build(source):
        if source not in built:
            k = len(built)
            cpp, so = out / f"step{k}.cpp", out / f"step{k}.so"
            cpp.write_text(env_codegen.host_source(source))
            subprocess.run([gxx, "-std=c++17", "-shared", "-fPIC", "-O1",
                            "-ffp-contract=off", "-o", str(so), str(cpp)],
                           check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(so))
            lib.user_step_eval.argtypes = [ctypes.c_void_p, ctypes.c_int] \
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] \
                + [ctypes.c_void_p] * 3
            lib.user_step_eval.restype = ctypes.c_int
            built[source] = lib
        return built[source]

    return build


def _host_step(lib, step, x, u):
    """The host functor on ``x [B, n]``, ``u [B, m]``: (x_next, cost,
    final cost)."""
    params = [p.to(torch.float64).contiguous() for p in step.params]
    ptrs = (ctypes.c_void_p * max(len(params), 1))(
        *[p.data_ptr() for p in params])
    xn = torch.empty_like(x)
    cost = torch.empty(x.shape[0], dtype=x.dtype)
    final = torch.empty(x.shape[0], dtype=x.dtype)
    rc = lib.user_step_eval(ptrs, len(params), x.data_ptr(), u.data_ptr(),
                            x.shape[0], xn.data_ptr(), cost.data_ptr(),
                            final.data_ptr())
    assert rc == 0
    return xn, cost, final


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("label", list(CASES))
def test_generated_functor_matches_torch_and_jax_steps(label, host_build):
    build, lohi = CASES[label]
    jenv, tenv = build()
    n, m = tenv.state_size, tenv.action_size
    rng = np.random.default_rng(list(CASES).index(label))
    x = torch.as_tensor(rng.uniform(*lohi, (B, n)))
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, m)))
    step = tenv.generic_device_step(torch.float64, "cpu")
    assert step.env_id == USER_STEP_ID and step.int_params == ()
    xn, cost, final = _host_step(host_build(step.source), step, x, u)

    _close(xn, tenv.transition(x, u), "x_next vs torch")
    _close(cost, tenv.cost(x, u), "cost vs torch")
    _close(final, tenv.final_cost(x), "final vs torch")

    _, step_fn, final_fn = jenv.generic_lane_functions()
    jx, ju = jnp.asarray(x.numpy().T), jnp.asarray(u.numpy().T)
    jxn, jcost = step_fn(jenv, jx, ju)
    _close(xn.numpy().T, jxn, "x_next vs JAX")
    _close(cost, jcost, "cost vs JAX")
    _close(final, final_fn(jenv, jx), "final vs JAX")


def test_prep_holds_what_every_row_reads_whole():
    """Navigation's lambda(x), a product over the zones that every row
    multiplies its control by, is computed once in ``prep``; the rows read
    it and compute only their own element. The chain's rows restrict the
    coupling product to one dot product each, and hold nothing in prep."""
    _, nav = _registry("navigation")
    src = nav.generic_device_step(torch.float64, "cpu").source
    assert "double h0[1];" in src and "pre.h0[0]" in src
    row = src[src.index("S row("):src.index("S stage_cost(")]
    assert "exp(" not in row and "for (" not in row
    _, chain = _chain(6)
    src = chain.generic_device_step(torch.float64, "cpu").source
    row = src[src.index("S row("):src.index("S stage_cost(")]
    assert "struct Pre {\n\n  };" in src
    assert row.count("for (") == 1 and "< 6;" in row


def test_supported_ops_match_the_torch_step(host_build):
    n = 5
    rng = np.random.default_rng(5)
    env = OpsEnv(W=torch.as_tensor(rng.standard_normal((n, n))),
                 c=torch.as_tensor(rng.uniform(-0.5, 0.5, n)),
                 k=torch.tensor(0.7, dtype=torch.float64))
    x = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, n)))
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, n)))
    step = env.generic_device_step(torch.float64, "cpu")
    xn, cost, final = _host_step(host_build(step.source), step, x, u)
    per = lambda f, *a: torch.stack([f(*(v[b] for v in a))  # noqa: E731
                                     for b in range(B)])
    _close(xn, per(env.transition, x, u), "x_next")
    _close(cost, per(env.cost, x, u), "cost")
    _close(final, per(env.final_cost, x), "final")


def test_source_depends_on_graph_dims_and_dtype_not_values():
    _, a = _chain(6)
    _, b = _chain(6, coupling_seed=3)
    src = a.generic_device_step(torch.float64, "cpu").source
    assert b.generic_device_step(torch.float64, "cpu").source == src
    assert a.generic_device_step(torch.float64, "cpu") is \
        a.generic_device_step(torch.float64, "cpu")   # traced once
    assert a.generic_device_step(torch.float32, "cpu").source != src
    assert _chain(7)[1].generic_device_step(torch.float64,
                                            "cpu").source != src
    # the default device step is the generated one; its parameters are
    # the env's tensors, read at launch
    step = b.device_step()
    assert step.env_id == USER_STEP_ID
    assert torch.equal(step.params[0], b.coupling)


@pytest.mark.parametrize("cls,what", [
    (Unsupported, "aten::cumsum"),
    (Branchy, "data-dependent"),
    (WideCost, "returned shape"),
])
def test_refusals_name_the_cause_and_the_opt_outs(cls, what):
    _, tenv = _fuzz_envs(11, 3, 3)
    env = cls(**{f.name: getattr(tenv, f.name)
                 for f in dataclasses.fields(tenv)})
    with pytest.raises(NotImplementedError, match=what) as info:
        env.device_step()
    assert "use_pallas=False" in str(info.value)
    assert "device_step()" in str(info.value)



def test_a_solve_raises_instead_of_falling_back():
    """``solve_batch(use_pallas=True)`` on an env whose step the generator
    refuses raises, on the CPU as on the card; ``use_pallas=False`` solves
    it on the plain path."""
    _, tenv = _fuzz_envs(11, 3, 3)
    env = Unsupported(**{f.name: getattr(tenv, f.name)
                         for f in dataclasses.fields(tenv)})
    x0 = torch.zeros(2, 3, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(max_iterations=2, use_pallas=True)
    with pytest.raises(NotImplementedError, match="aten::cumsum"):
        ilqr.solve_batch(env, x0, horizon=3, config=cfg)
    res = ilqr.solve_batch(env, x0, horizon=3,
                           config=dataclasses.replace(cfg, use_pallas=False))
    assert bool(torch.isfinite(res.total_cost).all())


def test_plan_family_follows_the_serial_work():
    """The launch plan of a generated step (``rollout.plan_family``): the
    chain, whose rows are most of its step, takes ``GENERIC_PLANS``'
    ``"user"`` rows; the (8, 3) fuzz env, whose stage cost's quadratic
    forms (computed whole by one lane) are as much work as its next
    state, the linear env's rows; a hand-written step its own."""
    from tfmpc_tpu_torch.ops import rollout

    cfg = ilqr.ILQRConfig()
    for env, want in ((_chain(6)[1], "user"), (_fuzz_envs(88, 8, 3)[1],
                                               "linear"),
                      (_registry("hvac")[1], None)):
        n, m = env.state_size, env.action_size
        X = torch.zeros(2, 4, n, dtype=torch.float64)
        U = torch.zeros(2, 3, m, dtype=torch.float64)
        policy = ilqr.backward(*ilqr.derivatives(env, X, U),
                               torch.zeros(2, dtype=torch.float64), cfg)[1]
        a = rollout.kernel_layout(env, X, U, policy)
        assert rollout.plan_family(a) == want
        if want is not None:
            serial, row = a["work"]
            assert serial > 0 and row > 0
