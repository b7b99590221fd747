"""The utilities of queue A6's second half in the PyTorch port vs the JAX
package: the ellipse search, ``threshold_components``, ``erode``,
``refilter``, ``color_order``, ``block_free_flags``, ``hals_nmf``,
``kmeans_pp``, ``sparse_nmf_init`` and ``local_correlation_projected``.
CPU tensors run the HALS kernel's plain version.

Tolerances: boolean masks, flags and permutations equal, but for the
ellipse masks at pixels whose r2 lies within 1e-4 of 1 and the
thresholded footprints at a pixel whose descending cumulative energy ties
the cut within 1e-5 of the footprint's energy (both float32 boundary
ties); ``refilter`` within 1e-5 of its scale, ``hals_nmf`` and the
k-means centres within 1e-4 of their scale, the correlation image within
1e-5. The k-means draws of the two packages differ (a CPU
``torch.Generator`` against ``jax.random``), so the JAX k-means++ draw is
replaced here by a deterministic farthest-point pick and the port starts
from the same centres through ``init``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.models import initialize as jinit
from cnmf_e_tpu.ops import coloring as jcol
from cnmf_e_tpu.ops import corr as jcorr
from cnmf_e_tpu.ops import hals as jhals
from cnmf_e_tpu.ops import lowrank as jlow
from cnmf_e_tpu.ops import morphology as jmorph
from cnmf_e_tpu.ops.filters import gaussian_psf
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.models import initialize as tinit
from cnmf_e_tpu_torch.ops import coloring as tcol
from cnmf_e_tpu_torch.ops import corr as tcorr
from cnmf_e_tpu_torch.ops import hals as thals
from cnmf_e_tpu_torch.ops import lowrank as tlow
from cnmf_e_tpu_torch.ops import morphology as tmorph

torch.set_num_threads(1)


def _footprints():
    """Simulated footprints, an elongated and a round one, and an empty
    slot."""
    gt = simulate_movie(seed=21, H=40, W=44, T=20, K=8, gSig=2.5,
                        min_dist=8.0)
    yy, xx = np.mgrid[0:40, 0:44]
    extra = np.stack([
        np.exp(-((yy - 15) ** 2 / 30.0 + (xx - 15) ** 2 / 6.0)),
        np.exp(-((yy - 25) ** 2 + (xx - 30) ** 2) / 8.0),
        np.exp(-(((yy - 20) + (xx - 22)) ** 2 / 40.0
                 + ((yy - 20) - (xx - 22)) ** 2 / 4.0)),
        np.zeros((40, 44))]).astype(np.float32)
    return np.concatenate([gt.A, extra]).astype(np.float32)


def _ellipse_r2(A, dist=3.0, lo=3.0, hi=8.0):
    """The JAX package's r2 (morphology.py:145-177) in float64."""
    A = A.astype(np.float64)
    K, H, W = A.shape
    yy, xx = np.mgrid[0:H, 0:W]
    mass = A.sum(axis=(1, 2)) + 1e-12
    cy = (A * yy).sum(axis=(1, 2)) / mass
    cx = (A * xx).sum(axis=(1, 2)) / mass
    dy = yy[None] - cy[:, None, None]
    dx = xx[None] - cx[:, None, None]
    cov = np.stack([np.stack([(A * dy * dy).sum((1, 2)),
                              (A * dx * dy).sum((1, 2))], -1),
                    np.stack([(A * dx * dy).sum((1, 2)),
                              (A * dx * dx).sum((1, 2))], -1)], -2)
    cov /= mass[:, None, None]
    ev, V = np.linalg.eigh(cov)
    ax = np.clip(np.sqrt(np.maximum(ev, 1e-6)) * dist, lo, hi)
    py = V[:, 0, 0, None, None] * dy + V[:, 1, 0, None, None] * dx
    px = V[:, 0, 1, None, None] * dy + V[:, 1, 1, None, None] * dx
    return (py / ax[:, 0, None, None]) ** 2 + (px / ax[:, 1, None, None]) ** 2


@pytest.mark.parametrize("dist", [3.0, 1.5])
def test_search_locations_ellipse_matches_jax(dist):
    A = _footprints()
    want = np.asarray(jmorph.search_locations_ellipse(jnp.asarray(A),
                                                      dist=dist))
    got = tmorph.search_locations_ellipse(torch.as_tensor(A),
                                          dist=dist).numpy()
    differ = got != want
    assert not (differ & (np.abs(_ellipse_r2(A, dist) - 1.0) > 1e-4)).any()
    assert want.any(axis=(1, 2)).all()


def test_search_locations_ellipse_gate():
    """tests/test_extras.py's gate: the mask reaches farther along the
    footprint's long axis."""
    A = np.zeros((1, 30, 30), np.float32)
    yy, xx = np.mgrid[0:30, 0:30]
    A[0] = np.exp(-((yy - 15) ** 2 / 30.0 + (xx - 15) ** 2 / 6.0))
    m = tmorph.search_locations_ellipse(torch.as_tensor(A)).numpy()
    assert m[0, 15, 15] and m[0, :, 15].sum() > m[0, 15, :].sum()


@pytest.mark.parametrize("frac", [0.99, 0.9, 0.5])
def test_threshold_components_matches_jax(frac):
    A = _footprints()
    A[:, ::3, ::4] *= 1.5                  # break the footprints' symmetry
    want = np.asarray(jmorph.threshold_components(jnp.asarray(A), frac))
    got = tmorph.threshold_components(torch.as_tensor(A), frac).numpy()
    for k in range(A.shape[0]):
        diff = np.nonzero((got[k] != want[k]).ravel())[0]
        if not diff.size:
            continue
        # one boundary pixel, at rank r of the descending energies: kept
        # iff the energy of the r pixels above it is below frac * total,
        # and that sum ties frac * total within rounding
        assert diff.size == 1, (k, diff)
        e = A[k].astype(np.float64).ravel() ** 2
        desc = np.sort(e)[::-1]
        r = int(np.nonzero(desc == e[diff[0]])[0][0])
        c = np.cumsum(desc)
        assert r > 0 and abs(c[r - 1] - frac * c[-1]) <= 1e-5 * c[-1], k


def test_threshold_components_gate():
    A = np.zeros((1, 10, 10), np.float32)
    A[0, 4:6, 4:6] = 1.0
    A[0, 0, 0] = 0.01
    out = tmorph.threshold_components(torch.as_tensor(A), 0.99).numpy()
    assert out[0, 4, 4] == 1.0 and out[0, 0, 0] == 0.0


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_erode_matches_jax(radius):
    mask = _footprints() > 0.2
    want = np.asarray(jmorph.erode(jnp.asarray(mask), radius))
    got = tmorph.erode(torch.as_tensor(mask), radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gSig", [2.0, 3.0])
def test_refilter_matches_jax(gSig):
    Y = simulate_movie(seed=4, H=32, W=36, T=80, K=4, gSig=2.5).Y
    psf = gaussian_psf(gSig, True)
    want = np.asarray(jinit.refilter(jnp.asarray(Y), psf))
    got = tinit.refilter(torch.as_tensor(Y), psf).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _overlap_graph(seed, K=40, density=0.08):
    rng = np.random.default_rng(seed)
    adj = rng.random((K, K)) < density
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    return adj


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_order_matches_jax(seed):
    adj = _overlap_graph(seed)
    jo, ji = jcol.color_order(jnp.asarray(adj))
    to, ti = tcol.color_order(torch.as_tensor(adj))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _coupling(block, gram):
    rng = np.random.default_rng(block)
    K = 45
    S = rng.random((K, 300)) < 0.01
    if gram == "overlap":                   # the mask-overlap Gram: counts
        X = S.astype(np.float32)
    else:                                   # the temporal Gram V = A A^T
        X = S * rng.random((K, 300)).astype(np.float32)
    gate = (rng.random(K) < 0.7).astype(np.float32)
    return X @ X.T, gate


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_block_free_flags_match_jax_on_the_overlap_gram(block, gated):
    """On integer couplings (the mask-overlap Gram) the JAX package's
    off-diagonal sum is exact, and the flags are equal."""
    V, gate = _coupling(block, "overlap")
    gate = gate if gated else None
    want = np.asarray(jcol.block_free_flags(
        jnp.asarray(V), block, None if gate is None else jnp.asarray(gate)))
    got = tcol.block_free_flags(
        torch.as_tensor(V), block,
        None if gate is None else torch.as_tensor(gate)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and 0 < got.sum() < len(got)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_block_free_flags_on_a_float_gram(block, gated):
    """On a float Gram the port flags exactly the blocks whose gated
    off-diagonal entries are all zero. The JAX package takes a block's
    sum less its trace, which float32 rounding can leave nonzero when
    every off-diagonal entry is zero, so its free blocks are a subset."""
    V, gate = _coupling(block, "float")
    g = gate if gated else np.ones(len(V), np.float32)
    got = tcol.block_free_flags(
        torch.as_tensor(V), block,
        torch.as_tensor(gate) if gated else None).numpy()
    Vg = V * g[:, None] * g[None, :]
    want = [int(not (np.abs(Vg[i:i + block, i:i + block])
                     * ~np.eye(len(Vg[i:i + block]), dtype=bool)).any())
            for i in range(0, len(V), block)]
    np.testing.assert_array_equal(got, want)
    jax_flags = np.asarray(jcol.block_free_flags(
        jnp.asarray(V), block, jnp.asarray(gate) if gated else None))
    assert (got >= jax_flags).all()


@pytest.mark.parametrize("masked", [False, True])
def test_hals_nmf_matches_jax(masked):
    gt = simulate_movie(seed=8, H=32, W=32, T=120, K=5, gSig=2.5, sn=0.05,
                        bg_strength=0.0, min_dist=9.0)
    rng = np.random.default_rng(1)
    K = gt.A.shape[0]
    Y = gt.Y.reshape(120, -1).T.astype(np.float32)
    A0 = (gt.A.reshape(K, -1).T * (1 + 0.3 * rng.random((1024, K)))
          ).astype(np.float32)
    C0 = np.abs(gt.C + 0.2 * rng.standard_normal(gt.C.shape)
                ).astype(np.float32)
    mask = (np.asarray(jmorph.search_locations_dilate(
        jnp.asarray(gt.A), radius=3)).reshape(K, -1).T if masked else None)
    Aj, Cj = jhals.hals_nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(C0),
                            n_iter=10, mask=None if mask is None
                            else jnp.asarray(mask))
    At, Ct = thals.hals_nmf(torch.as_tensor(Y), torch.as_tensor(A0),
                            torch.as_tensor(C0), n_iter=10,
                            mask=None if mask is None
                            else torch.as_tensor(mask))
    Aj, Cj = np.asarray(Aj), np.asarray(Cj)
    np.testing.assert_allclose(At.numpy(), Aj, atol=1e-4 * np.abs(Aj).max())
    np.testing.assert_allclose(Ct.numpy(), Cj, atol=1e-4 * np.abs(Cj).max())
    if masked:
        assert not At.numpy()[~mask].any()


def _farthest_point_start(X, k):
    """The centres the JAX k-means++ picks when its draw takes the most
    probable row, starting from row 0."""
    centers = [X[0]]
    d2 = ((X - X[0]) ** 2).sum(-1)
    for _ in range(1, k):
        centers.append(X[int(np.argmax(d2))])
        d2 = np.minimum(d2, ((X - centers[-1]) ** 2).sum(-1))
    return np.stack(centers)


@pytest.fixture
def jax_farthest_point(monkeypatch):
    monkeypatch.setattr(jax.random, "choice",
                        lambda key, n, p=None, **kw: jnp.argmax(p))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, **kw:
                        jnp.zeros(shape, jnp.int32))


@pytest.mark.parametrize("k", [2, 5])
def test_kmeans_lloyd_steps_match_jax(jax_farthest_point, k):
    rng = np.random.default_rng(k)
    X = np.concatenate([rng.normal(c, 0.3, (40, 6)) for c in range(k + 1)]
                       ).astype(np.float32)
    cj, lj = jlow.kmeans_pp(jnp.asarray(X), k, n_iter=10)
    start = _farthest_point_start(X, k)
    ct, lt = tlow.kmeans_pp(torch.as_tensor(X), k, n_iter=10,
                            init=torch.as_tensor(start))
    cj = np.asarray(cj)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ct.numpy(), cj, atol=1e-4 * np.abs(cj).max())


def test_kmeans_pp_gate():
    """tests/test_extras.py's gate on the port's own draws."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 0.1, (50, 2)),
                        rng.normal(5, 0.1, (60, 2))]).astype(np.float32)
    centers, labels = tlow.kmeans_pp(torch.as_tensor(X), 2, seed=1)
    d = np.sort(np.linalg.norm(centers.numpy(), axis=1))
    assert d[0] < 0.5 and abs(d[1] - np.sqrt(50)) < 1.0
    assert labels.shape == (110,)


def _nmf_movie():
    return simulate_movie(seed=51, H=32, W=32, T=200, K=4, sn=0.03,
                          bg_strength=0.0, min_dist=10.0, spike_rate=0.06)


def test_sparse_nmf_init_matches_jax(jax_farthest_point):
    gt = _nmf_movie()
    Aj, Cj = jlow.sparse_nmf_init(jnp.asarray(gt.Y), K=6, n_iter=20)
    Yf = np.maximum(gt.Y.reshape(200, -1).T, 0.0)
    start = _farthest_point_start(Yf, 6)
    At, Ct = tlow.sparse_nmf_init(torch.as_tensor(gt.Y), K=6, n_iter=20,
                                  init=torch.as_tensor(start))
    Aj, Cj = np.asarray(Aj), np.asarray(Cj)
    np.testing.assert_allclose(At.numpy(), Aj, atol=1e-4 * np.abs(Aj).max())
    np.testing.assert_allclose(Ct.numpy(), Cj, atol=1e-4 * np.abs(Cj).max())


def test_sparse_nmf_init_gate():
    """tests/test_extras.py's gate on the port's own draws."""
    gt = _nmf_movie()
    A, C = tlow.sparse_nmf_init(torch.as_tensor(gt.Y), K=6, seed=0)
    assert A.shape == (6, 32, 32) and C.shape == (6, 200)
    recon = np.einsum("khw,kt->thw", A.numpy(), C.numpy())
    assert np.linalg.norm(gt.Y - recon) < 0.6 * np.linalg.norm(gt.Y)


@pytest.mark.parametrize("k", [50, 1000])
def test_local_correlation_projected_matches_jax(k):
    """The port's projected correlation image equals the JAX
    ``correlation_image`` of the same projection (the port's draws)."""
    Y = simulate_movie(seed=12, H=28, W=30, T=300, K=4, gSig=2.5).Y
    got = tcorr.local_correlation_projected(torch.as_tensor(Y), k=k,
                                            seed=3).numpy()
    kk = min(k, 300)
    R = torch.randn((300, kk), generator=torch.Generator().manual_seed(3)
                    ).numpy() / np.sqrt(300)
    P = np.einsum("thw,tk->khw", Y - Y.mean(axis=0, keepdims=True), R)
    want = np.asarray(jcorr.correlation_image(jnp.asarray(P.astype(
        np.float32)), center=False))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.shape == (28, 30)
