"""The other paths of ``fit_streaming`` against the JAX package's, on the
store of ``tests/test_torch_streaming.py``: the decimated init at
``init.ssub=2`` (footprints resized back linearly), iteration 0 without
the strided ring bootstrap, and resuming from snapshots the JAX package
wrote (its init snapshot, and a traces snapshot that continues at the ring
fit)."""

import dataclasses

import numpy as np
import pytest
import torch

from cnmf_e_tpu.models import streaming as jax_streaming
from cnmf_e_tpu_torch.convert import params_from_dict
from cnmf_e_tpu_torch.models import streaming
from test_torch_streaming import (assert_fits_match, fit_both, make_store,
                                  stream_params)

torch.set_num_threads(1)


def test_ssub2_init_matches_the_jax_package(tmp_path):
    assert_fits_match(*fit_both(tmp_path / "store", stream_params(ssub=2)))


def test_without_ring_bootstrap_matches_the_jax_package(tmp_path):
    p = stream_params()
    p = p.replace(background=dataclasses.replace(p.background,
                                                 ring_bootstrap=False))
    assert_fits_match(*fit_both(tmp_path / "store", p))


@pytest.fixture(scope="module")
def jax_snapshots(tmp_path_factory):
    """A JAX init snapshot (n_outer = 0 stops right after it), and a JAX
    traces snapshot: the full-T C of a one-iteration fit, saved as its
    ``iter0_traces`` stage."""
    root = tmp_path_factory.mktemp("snap")
    jstore, _ = make_store(root / "store")
    init = str(root / "init.npz")
    jax_streaming.fit_streaming(jstore, stream_params(), n_outer=0,
                                init_budget_frames=300, snapshot_path=init)
    full = str(root / "full.npz")
    jax_streaming.fit_streaming(jstore, stream_params(), n_outer=1,
                                init_budget_frames=300, snapshot_path=full)
    with np.load(full) as z:
        assert str(z["stage"]) == "iter0" and "C" in z.files
        traces = {k: z[k] for k in z.files}
    traces["stage"] = np.asarray("iter0_traces")
    np.savez(str(root / "traces.npz"), **traces)
    with np.load(init) as z:
        assert str(z["stage"]) == "init" and "C" not in z.files
    return root


@pytest.mark.parametrize("snap", ["init", "traces"])
def test_resume_from_a_jax_snapshot(jax_snapshots, tmp_path, snap):
    """Both packages resume the same JAX-written snapshot (the init one
    skips the proxy init; the traces one skips iteration 0's temporal
    pass) and agree."""
    jstore, tstore = make_store(jax_snapshots / "store")
    src = jax_snapshots / f"{snap}.npz"
    paths = []
    for who in ("jax", "torch"):
        p = tmp_path / f"{who}.npz"
        p.write_bytes(src.read_bytes())
        paths.append(str(p))
    ref = jax_streaming.fit_streaming(jstore, stream_params(), n_outer=1,
                                      init_budget_frames=300,
                                      snapshot_path=paths[0])
    port = streaming.fit_streaming(
        tstore, params_from_dict(dataclasses.asdict(stream_params())),
        n_outer=1, init_budget_frames=300, snapshot_path=paths[1],
        device="cpu")
    assert_fits_match(ref, port)
    # and each wrote the same snapshot keys and dtypes
    with np.load(paths[0]) as zj, np.load(paths[1]) as zt:
        assert zj.files == zt.files
        assert str(zt["stage"]) == str(zj["stage"]) == "iter0"
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            assert zt[k].shape == zj[k].shape, k
