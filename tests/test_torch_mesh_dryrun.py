"""The multi-device dry run of ``__graft_entry__.py::dryrun_multichip``
(``:37-77``) for the port: the coloured update step at its tiny shapes on
1, 2, 4 and 8 gloo ranks (n_frame = 2 where the count is even), held to
the JAX single-device step on the same inputs (A atol 2e-4, C and S 2e-3,
``tests/test_sharding.py``'s tolerances). On one rank the 1 x 1 mesh runs
every collective of the mesh branch on a group of one, and its result is
bit-identical to the ``mesh=None`` step. Each spawn has a 120 s deadline
and every process group a 60 s timeout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.ops.ring import ring_offsets
from cnmf_e_tpu.parallel.step import StepState, make_update_step
from cnmf_e_tpu_torch.convert import (step_state_from_numpy,
                                      step_state_to_numpy)
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel import step as tstep
from cnmf_e_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)


def _problem(n_devices):
    """``dryrun_multichip``'s mesh shape and inputs."""
    n_frame = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_patch = n_devices // n_frame
    H, W, T = 8 * n_patch, 16, 64 * n_frame
    K = max(8, n_patch) * 2
    K = ((K + n_patch - 1) // n_patch) * n_patch
    radius = 3
    R = ring_offsets(radius).shape[0]
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((T, H, W)).astype(np.float32)
    d = dict(A=np.abs(rng.standard_normal((K, H, W))).astype(np.float32),
             C=np.abs(rng.standard_normal((K, T))).astype(np.float32),
             C_raw=np.zeros((K, T), np.float32),
             S=np.zeros((K, T), np.float32),
             g=np.full((K,), 0.9, np.float32),
             b0=np.zeros((H, W), np.float32),
             ring_w=np.zeros((H * W, R), np.float32),
             ring_w0=np.zeros((H * W,), np.float32))
    return n_patch, n_frame, (H, W, T, radius), Y, d


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_colored_step_dryrun(n_devices):
    n_patch, n_frame, (H, W, T, radius), Y, d = _problem(n_devices)
    kw = dict(n_hals=1, colored=True)
    out = spawn(_selftest.step_cases, n_patch, n_frame, device="cpu",
                args=(Y, d, H, W, T, radius, [("colored", kw)]),
                timeout=120, pg_timeout=60)
    got = out[0]["colored"]
    assert got["A"].shape == d["A"].shape
    want = make_update_step(None, H, W, T, radius=radius, **kw)(
        jnp.asarray(Y), StepState(**{k: jnp.asarray(v)
                                     for k, v in d.items()}))
    np.testing.assert_allclose(got["A"], np.asarray(want.A), atol=2e-4)
    np.testing.assert_allclose(got["C"], np.asarray(want.C), atol=2e-3)
    np.testing.assert_allclose(got["S"], np.asarray(want.S), atol=2e-3)
    if n_devices == 1:
        single = step_state_to_numpy(tstep.make_update_step(
            None, H, W, T, radius=radius, **kw)(
            torch.tensor(Y), step_state_from_numpy(d, device="cpu")))
        for k, v in single.items():
            np.testing.assert_array_equal(got[k], v)
