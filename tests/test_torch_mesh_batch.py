"""``fit_batches(mesh=...)`` of the port on a 2 x 2 mesh of gloo ranks.

``tests/test_torch_batch.py``'s movie (48x48x900 in three batches of
300 frames; each rank holds 150 frames x 24 rows of each batch) is fitted
on the mesh and held to the port's one-process ``fit_batches`` and to the
JAX package's at that file's bars: the same n_active and per-batch
neuron counts, every active footprint and trace at correlation >= 0.99,
equal tags; every rank returns the same state bit for bit and calls no
object collective of torch.distributed (no pickled state); rank 0
writes the run log's snapshots as one process does.

Each stage also runs alone on the mesh against one process, in the same
spawn: ``init_traces_given_A`` (traces within 1e-3 of their scale),
``residual_pick_batch`` on a movie whose neuron 0 fires only after the
first batch (the same neuron picked; the centroid gate's centroids within
1e-9 pixels of one process's centroids of the same footprints, and within
1e-4 pixels of one process's pick), the spatial sync (A within 1e-4 of its
scale) and the concatenation of the traces over time (each rank's frames
of the session, bit for bit those of one process's joined traces); and
the ValueError of a batch whose frames do not divide over 'frame'. The
spawn has a 240 s deadline and every process group a 60 s timeout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.models import batch as jax_batch
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.checkpoint import RunLog
from cnmf_e_tpu_torch.convert import params_from_dict, state_to_numpy
from cnmf_e_tpu_torch.models import batch
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

N_PATCH, N_FRAME = 2, 2
T_B = 300                   # frames a batch
LATE = 0                    # the neuron that fires only after batch 1


def _params():
    """``tests/test_torch_batch.py``'s parameters."""
    return CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=4),
        background=BackgroundParams(model="ring", ring_radius=9),
        merge=MergeParams(dmin=4.0))


def _late_movie(gt):
    """The movie with neuron LATE silent in the first batch."""
    Y = gt.Y.copy()
    Y[:T_B] -= np.einsum("t,hw->thw", gt.C[LATE, :T_B],
                         gt.A[LATE]).astype(np.float32)
    return Y


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    gt = simulate_movie(seed=21, H=48, W=48, T=900, K=7, gSig=2.5, sn=0.08,
                        bg_strength=0.7, min_dist=12.0, spike_rate=0.04)
    batches = [gt.Y[:T_B], gt.Y[T_B:2 * T_B], gt.Y[2 * T_B:]]
    pd = dataclasses.asdict(_params())
    p = params_from_dict(pd)
    root = tmp_path_factory.mktemp("mesh_batch")
    log = RunLog(str(root / "one"), run_name="batch")
    port, port_b = batch.fit_batches(batches, p, device="cpu", run_log=log)
    ref, ref_b = jax_batch.fit_batches(batches, _params())

    # the stages' one-process inputs and results
    Y = _late_movie(gt)
    Y2 = torch.tensor(Y[T_B:2 * T_B])
    st0 = CNMFE(p, device="cpu").fit(Y[:T_B], n_outer=1)
    st_b = batch.init_traces_given_A(Y2, st0, p)
    pick = batch.residual_pick_batch(Y2, st_b, p)
    sync = batch.sync_footprints(port_b, map(torch.tensor, batches), p)
    states = [state_to_numpy(s) for s in port_b]
    jobs = [("fit", "batch_case", (batches, pd, str(root / "mesh"))),
            ("stages", "batch_stage_cases", (
                Y2.numpy(), state_to_numpy(st0), Y2.numpy(),
                state_to_numpy(st_b), batches, states, pd)),
            ("guard", "batch_guard_case", (batches, pd))]
    ranks = spawn(_selftest.cases, N_PATCH, N_FRAME, device="cpu",
                  args=(jobs,), timeout=240, pg_timeout=60)
    return dict(
        ranks=ranks, snaps=_selftest.snapshot_stages(log.dir),
        port=(state_to_numpy(port), [int(s.n_active()) for s in port_b]),
        jax=(dict(A=np.asarray(ref.A), C=np.asarray(ref.C),
                  C_raw=np.asarray(ref.C_raw), active=np.asarray(ref.active),
                  tags=np.asarray(ref.tags)),
             [int(s.n_active()) for s in ref_b]),
        st0=st0, init=state_to_numpy(st_b), pick=state_to_numpy(pick),
        centroids=np.stack(batch.centroids(pick.A)), sync=sync.numpy(),
        concat={k: batch.concat_traces(port_b, k).numpy()
                for k in ("C", "C_raw", "S")})


@pytest.mark.parametrize("against", ["port", "jax"])
def test_fit_batches_mesh_matches_one_process(fits, against):
    got = fits["ranks"][0]["fit"]
    st = got["state"]
    want, want_counts = fits[against]
    np.testing.assert_array_equal(st["active"], want["active"])
    assert int(st["active"].sum()) > 0
    assert got["per_batch"] == want_counts
    assert st["C"].shape == (16, 900) and st["S"].shape == (16, 900)
    for k in np.nonzero(want["active"])[0]:
        assert np.corrcoef(st["A"][k].ravel(),
                           want["A"][k].ravel())[0, 1] >= 0.99, k
        for key in ("C", "C_raw"):
            assert np.corrcoef(st[key][k], want[key][k])[0, 1] >= 0.99, \
                (key, k)
    np.testing.assert_array_equal(st["tags"], want["tags"])


def test_every_rank_returns_the_same_state(fits):
    """Every rank's full state is bit-identical and its per-batch counts
    equal; no rank called an object collective (pickled state)."""
    first = fits["ranks"][0]["fit"]
    for r in fits["ranks"]:
        assert r["fit"]["digest"] == first["digest"]
        assert r["fit"]["per_batch"] == first["per_batch"]
        assert r["fit"]["broadcasts"] == 0


def test_run_log_of_the_mesh(fits):
    """Rank 0 writes the run log's snapshots (batch 1's fit, each later
    batch, the final state) as one process does."""
    got = fits["ranks"][0]["fit"]["snaps"]
    assert got == fits["snaps"] and got[-1] == "batch_final", got


def test_init_traces_given_A_on_the_mesh(fits):
    got = fits["ranks"][0]["stages"]["init"]
    want = fits["init"]
    np.testing.assert_array_equal(got["active"], want["active"])
    for k in ("C", "C_raw", "S"):
        scale = max(np.abs(want[k]).max(), 1.0)
        assert np.abs(got[k] - want[k]).max() <= 1e-3 * scale, k
    np.testing.assert_allclose(got["g"], want["g"], atol=1e-3)


def test_residual_pick_of_a_late_neuron_on_the_mesh(fits):
    """Batch 1 misses neuron LATE; the residual pick of batch 2 finds it
    on the mesh as in one process, and the centroids the distance gate
    reads (the rows offset by each slab's first row, the moments summed
    over 'patch') are one process's."""
    got = fits["ranks"][0]["stages"]["pick"]
    want = fits["pick"]
    n0 = int(fits["st0"].n_active())
    assert int(want["active"].sum()) == n0 + 1
    np.testing.assert_array_equal(got["active"], want["active"])
    scale = np.abs(want["A"]).max()
    assert np.abs(got["A"] - want["A"]).max() <= 1e-4 * scale
    act = want["active"]
    mine = np.stack(batch.centroids(torch.tensor(got["A"])))
    for r in fits["ranks"]:
        c = r["stages"]["pick"]["centroids"][:, act]
        np.testing.assert_allclose(c, mine[:, act], rtol=0, atol=1e-9)
        np.testing.assert_allclose(c, fits["centroids"][:, act], rtol=0,
                                   atol=1e-4)


def test_spatial_sync_on_the_mesh(fits):
    got = fits["ranks"][0]["stages"]["sync"]
    want = fits["sync"]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("rank", range(N_PATCH * N_FRAME))
def test_concatenated_traces_are_contiguous_frames(fits, rank):
    """Rank (f, p) holds frames [f T / n_frame, (f + 1) T / n_frame) of the
    session, in order: one process's joined traces, bit for bit."""
    f = rank // N_PATCH
    got = fits["ranks"][rank]["stages"]["concat"]
    for k, want in fits["concat"].items():
        n = want.shape[1] // N_FRAME
        np.testing.assert_array_equal(got[k], want[:, f * n:(f + 1) * n],
                                      err_msg=k)


def test_a_batch_that_does_not_divide_raises(fits):
    """Batch 2's blocks differ by a frame: every rank raises a ValueError
    that names the batch and the dimension, before any stage runs."""
    for r in fits["ranks"]:
        msg = r["guard"]
        assert msg is not None and "batch 2" in msg and "in T" in msg, msg
