"""AR(2) states through the port's out-of-core path and checkpoints:
``fit_streaming`` with the ``ar2_constrained`` deconvolution against the
JAX package on the 48x48x600 store of ``tests/test_torch_streaming.py``,
resuming from a snapshot that carries no g (the AR order then comes from
the deconvolution model in both packages), ``fit_batches``, and an AR(2)
state crossing the two packages through ``results.npz``.

Tolerances: the same neurons, footprints and traces matched at
correlation >= 0.99 and equal tags (``assert_fits_match``); g of width 2;
restored arrays equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnmf_e_tpu.checkpoint import restore_state as jax_restore_state
from cnmf_e_tpu.config import DeconvParams, TemporalParams
from cnmf_e_tpu.io.export import save_results as jax_save_results
from cnmf_e_tpu.models import streaming as jax_streaming
from cnmf_e_tpu_torch.checkpoint import restore_state
from cnmf_e_tpu_torch.convert import params_from_dict
from cnmf_e_tpu_torch.io.export import save_results
from cnmf_e_tpu_torch.models import streaming
from cnmf_e_tpu_torch.models.batch import fit_batches
from tests.test_torch_streaming import (assert_fits_match, fit_both,
                                        make_store, stream_params)

torch.set_num_threads(1)


def _params():
    return stream_params().replace(temporal=TemporalParams(
        deconv=DeconvParams(model="ar2", method="constrained")))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("ar2") / "store"
    ref, port = fit_both(root, _params())
    return root, ref, port


def test_fit_streaming_ar2_matches_jax(fits):
    _, ref, port = fits
    assert port.g.shape[1] == 2 == ref.g.shape[1]
    n = int(port.n_active())
    assert np.any(np.abs(port.g[:n, 1].numpy()) > 1e-4)
    assert_fits_match(ref, port)


def test_fit_streaming_ar2_resume_without_g(fits, tmp_path):
    """A snapshot with footprints only: both packages size g by the
    deconvolution model (width 2) and fit the same neurons."""
    root, ref, _ = fits
    n = int(ref.n_active())
    snaps = []
    for name in ("jax", "port"):
        snaps.append(str(tmp_path / f"{name}.npz"))
        np.savez(snaps[-1], A=np.asarray(ref.A), active=np.asarray(
            ref.active), stage="init")
    jstore, tstore = make_store(tmp_path / "store")
    kw = dict(n_outer=1, init_budget_frames=300)
    r2 = jax_streaming.fit_streaming(jstore, _params(), snapshot_path=snaps[0],
                                     **kw)
    p2 = streaming.fit_streaming(
        tstore, params_from_dict(dataclasses.asdict(_params())),
        device="cpu", snapshot_path=snaps[1], **kw)
    assert p2.g.shape[1] == 2 == r2.g.shape[1]
    assert int(p2.n_active()) <= n
    assert_fits_match(r2, p2)


def test_fit_batches_ar2(fits):
    """Two 150-frame batches of the movie carry g of width 2."""
    root, _, _ = fits
    _, tstore = make_store(root.parent / "batches")
    Y = np.asarray(tstore.read_frames(0, 300), np.float32)
    st, _ = fit_batches([Y[:150], Y[150:]],
                        params_from_dict(dataclasses.asdict(_params())),
                        n_outer=1, device="cpu")
    assert st.g.shape[1] == 2
    assert int(st.n_active()) > 0
    assert torch.isfinite(st.C).all() and torch.isfinite(st.g).all()


def test_ar2_state_crosses_packages(fits, tmp_path):
    _, ref, port = fits
    K, (H, W), T = ref.A.shape[0], ref.A.shape[1:], ref.C.shape[1]
    jax_save_results(str(tmp_path / "jax"), ref)
    ours = restore_state(str(tmp_path / "jax.npz"), K, H, W, T,
                         device="cpu")
    n = int(ref.n_active())
    assert ours.g.shape == (K, 2)
    np.testing.assert_array_equal(ours.g[:n].numpy(), np.asarray(ref.g)[:n])
    save_results(str(tmp_path / "port"), port)
    theirs = jax_restore_state(str(tmp_path / "port.npz"), K, H, W, T)
    m = int(port.n_active())
    assert theirs.g.shape == (K, 2)
    np.testing.assert_array_equal(np.asarray(theirs.g)[:m],
                                  port.g[:m].numpy())
