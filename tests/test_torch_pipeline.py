"""The whole ``CNMFE.fit`` in the PyTorch port vs the JAX package.

Both packages fit the same simulated 1p movie (ring background on the
ssub=2 coarse grid, as ``CNMFEParams.preset_1p`` sets it) on the CPU. They
must find the same number of neurons, footprints and traces must match
with correlation >= 0.99, and both must score the same F1 against ground
truth. Also: the state <-> numpy round trip, and that the port never
loads jax.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.utils.metrics import detection_f1
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import (params_from_dict, state_from_numpy,
                                      state_to_numpy)
from cnmf_e_tpu_torch.models.pipeline import CNMFE

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params():
    return CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=24, seeds_per_round=16, max_rounds=6),
        background=BackgroundParams(model="ring", ring_radius=9, ssub=2),
        merge=MergeParams(dmin=4.0))


@pytest.fixture(scope="module")
def fits():
    gt = simulate_movie(seed=11, H=48, W=48, T=300, K=6, gSig=2.5, sn=0.08,
                        bg_strength=0.8, min_dist=12.0, spike_rate=0.04)
    params = _params()
    port = CNMFE(params_from_dict(dataclasses.asdict(params)), device="cpu")
    port.fit(gt.Y, n_outer=2)
    ref = JaxCNMFE(params)
    ref.fit(jnp.asarray(gt.Y), n_outer=2)
    return gt, port, ref


def test_fit_same_neuron_count(fits):
    _, port, ref = fits
    n = int(port.state.n_active())
    assert n == int(ref.state.n_active()) > 0
    # compacted: the active slots lead
    assert bool(port.state.active[:n].all())


def test_fit_footprints_and_traces_match(fits):
    _, port, ref = fits
    n = int(port.state.n_active())
    A_t = port.state.A[:n].numpy().reshape(n, -1)
    C_t = port.state.C[:n].numpy()
    A_j = np.asarray(ref.state.A)[:n].reshape(n, -1)
    C_j = np.asarray(ref.state.C)[:n]
    for k in range(n):
        assert np.corrcoef(A_t[k], A_j[k])[0, 1] >= 0.99, k
        assert np.corrcoef(C_t[k], C_j[k])[0, 1] >= 0.99, k


def test_fit_same_f1_against_ground_truth(fits):
    gt, port, ref = fits
    n = int(port.state.n_active())
    f_t = detection_f1(port.state.A[:n].numpy(), gt.A)
    f_j = detection_f1(np.asarray(ref.state.A)[:n], gt.A)
    assert f_t["f1"] == f_j["f1"]
    assert f_t["f1"] >= 0.8


def test_fit_background_reconstruction_and_rss_match(fits):
    gt, port, ref = fits
    np.testing.assert_allclose(port.background(gt.Y).numpy(),
                               np.asarray(ref.background(gt.Y)),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(port.reconstruction(gt.Y).numpy(),
                               np.asarray(ref.reconstruction(gt.Y)),
                               rtol=1e-3, atol=1e-3)
    rss_t, rss_j = port.compute_rss(gt.Y), ref.compute_rss(gt.Y)
    assert abs(rss_t - rss_j) <= 1e-3 * rss_j
    tags_t = port.state.tags.numpy()
    np.testing.assert_array_equal(tags_t, np.asarray(ref.state.tags))


def test_state_numpy_round_trip(fits):
    _, port, _ = fits
    d = state_to_numpy(port.state)
    assert {"A", "C", "C_raw", "S", "g", "neuron_sn", "b0", "tags",
            "ring_w", "ring_w0", "active"} <= set(d)
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype
    # float64 input arrives as float32; an export bundle (no "active")
    # loads with every slot active
    d64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
           for k, v in d.items() if k != "active"}
    st = state_from_numpy(d64, device="cpu")
    assert st.A.dtype == torch.float32 and bool(st.active.all())


def test_port_never_imports_jax():
    """Nor anything of the JAX package: the fit runs on the port's own
    config and simulation."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import cnmf_e_tpu_torch
        from cnmf_e_tpu_torch.config import (BackgroundParams, CNMFEParams,
                                             InitParams)
        from cnmf_e_tpu_torch.utils.simulate import simulate_movie
        from cnmf_e_tpu_torch.models.pipeline import CNMFE
        gt = simulate_movie(seed=2, H=24, W=24, T=120, K=3, gSig=2.0,
                            sn=0.05, min_dist=8.0, spike_rate=0.05)
        p = CNMFEParams(init=InitParams(gSig=2.0, gSiz=7, max_neurons=6,
                                        seeds_per_round=4, max_rounds=2),
                        background=BackgroundParams(ring_radius=5, ssub=2))
        CNMFE(p, device="cpu").fit(gt.Y, n_outer=1)
        import cnmf_e_tpu_torch.parallel.step
        import cnmf_e_tpu_torch.convert
        import cnmf_e_tpu_torch.models.streaming
        import cnmf_e_tpu_torch.models.batch
        import cnmf_e_tpu_torch.io.export
        import cnmf_e_tpu_torch.checkpoint
        import cnmf_e_tpu_torch.utils.profiling
        import cnmf_e_tpu_torch.run
        import cnmf_e_tpu_torch.models.dff
        import cnmf_e_tpu_torch.ops.lowrank
        import cnmf_e_tpu_torch.ops.kde
        import cnmf_e_tpu_torch.utils.viz
        import cnmf_e_tpu_torch.utils.report
        assert "jax" not in sys.modules, "jax was imported"
        jax_pkg = sorted(m for m in sys.modules
                         if m.split(".")[0] == "cnmf_e_tpu")
        assert not jax_pkg, f"the JAX package was imported: {jax_pkg}"
        print("NO_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout


def test_kernel_wrappers_take_plain_path_only_for_cpu_tensors():
    """A CPU tensor runs the plain version; nothing is launched."""
    from cnmf_e_tpu_torch import cuda_build
    from cnmf_e_tpu_torch.ops.oasis import oasis_ar1
    cuda_build.reset_launch_counts()
    y = torch.randn(3, 200)
    c, s = oasis_ar1(y, torch.full((3,), 0.9))
    assert c.shape == y.shape and bool(torch.isfinite(c).all())
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())
    assert not cuda_build.ENTRY_CALLS


# options that raised until the port took them (temporal.decorrelate and
# the AR(2) deconvolution, then the local background and the ellipse
# search): they now run
PORTED = {
    "decorrelate": lambda p: p.replace(temporal=dataclasses.replace(
        p.temporal, decorrelate=True)),
    "ar2": lambda p: p.replace(temporal=dataclasses.replace(
        p.temporal, deconv=dataclasses.replace(p.temporal.deconv,
                                               model="ar2"))),
    "local_background": lambda p: p.replace(background=dataclasses.replace(
        p.background, model="local")),
    "ellipse_search": lambda p: p.replace(spatial=dataclasses.replace(
        p.spatial, search_method="ellipse")),
}


@pytest.mark.parametrize("option", sorted(PORTED))
def test_formerly_unported_options_run(option):
    p = PORTED[option](params_from_dict(dataclasses.asdict(_params())))
    st = CNMFE(p, device="cpu").fit(
        np.random.default_rng(0).random((20, 8, 8), np.float32))
    assert st.g.shape[1] == (2 if option == "ar2" else 1)
    assert bool(torch.isfinite(st.C).all())


@pytest.mark.parametrize("model", ["svd", "nmf"])
def test_lowrank_background_options_run(model):
    """Ported with the 2p preset: svd and nmf backgrounds fit (here an
    empty movie, where no neuron is found)."""
    p = params_from_dict(dataclasses.asdict(_params()))
    st = CNMFE(p.replace(background=dataclasses.replace(
        p.background, model=model, rank=2)), device="cpu").fit(
            np.random.default_rng(0).random((20, 8, 8), np.float32))
    assert st.b.shape == (2, 8, 8) and st.f.shape == (2, 20)
    assert bool(torch.isfinite(st.b0).all())
