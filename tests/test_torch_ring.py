"""Ring kernels of the PyTorch port vs the JAX package.

The port's ring kernels run here as their plain PyTorch versions (CPU
tensors): K6's stencil against ``apply_ring_pallas`` in interpret mode
(atol 1e-5, as ``tests/test_pallas_ring.py``), the banded products K5 and
K7 against ``apply_ring_mxu_flat``/``apply_ring_mxu`` in interpret mode at
1e-5 of the output's scale (both sides compute in f32 on the same bf16
values, so only the summation order differs), and ``ring_dense_bands``
bit for bit. The dispatching ``ops.ring.apply_ring`` and
``reconstruct_ring_background`` with ``ssub=1`` go against the JAX XLA
forms.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.ops import ring as jring
from cnmf_e_tpu.ops.pallas_ring import apply_ring_pallas, ring_apply_auto
from cnmf_e_tpu.ops.pallas_ring_mxu import (apply_ring_mxu,
                                            apply_ring_mxu_flat,
                                            ring_dense_bands)
from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.ops import ring as tring
from cnmf_e_tpu_torch.ops import ring_kernels as rk

torch.set_num_threads(1)


def _problem(seed, T, H, W, radius, scale=0.1, bias=0.0):
    rng = np.random.default_rng(seed)
    R = jring.ring_offsets(radius).shape[0]
    X = rng.standard_normal((T, H, W)).astype(np.float32)
    w = (rng.standard_normal((H * W, R)) * scale + bias).astype(np.float32)
    w0 = rng.standard_normal(H * W).astype(np.float32)
    return X, w, w0


def _weights(w, w0):
    return (jring.RingWeights(w=jnp.asarray(w), w0=jnp.asarray(w0)),
            RingWeights(w=torch.tensor(w), w0=torch.tensor(w0)))


def test_stencil_reference_matches_pallas_interpret():
    H = W = 128
    T, radius = 8, 5
    X, w, w0 = _problem(0, T, H, W, radius)
    wj, _ = _weights(w, w0)
    want = np.asarray(apply_ring_pallas(wj, jnp.asarray(X), H, W, radius,
                                        interpret=True))
    got = rk.apply_ring_stencil_reference(torch.tensor(w), torch.tensor(w0),
                                          torch.tensor(X), H, W,
                                          radius).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("H,W,radius", [(16, 128, 4), (9, 13, 3)])
def test_dense_bands_bit_identical(H, W, radius):
    _, w, w0 = _problem(1, 1, H, W, radius, bias=0.05)
    wj, wt = _weights(w, w0)
    want = np.asarray(ring_dense_bands(wj, H, W, radius)).view(np.uint16)
    got = rk.ring_dense_bands(wt, H, W, radius)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("intercept", [True, False])
def test_banded_flat_reference_matches_pallas_interpret(intercept):
    H, W, T, radius = 16, 128, 24, 4
    X, w, w0 = _problem(2, T, H, W, radius, bias=0.05)
    if not intercept:
        w0 = np.zeros_like(w0)
    wj, wt = _weights(w, w0)
    want = np.asarray(apply_ring_mxu_flat(ring_dense_bands(wj, H, W, radius),
                                          jnp.asarray(w0), jnp.asarray(X),
                                          H, W, radius, interpret=True))
    got = rk.apply_ring_mxu_flat_reference(
        rk.ring_dense_bands(wt, H, W, radius), torch.tensor(w0),
        torch.tensor(X), H, W, radius).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


@pytest.mark.parametrize("intercept", [True, False])
def test_banded_htw_reference_matches_pallas_interpret(intercept):
    H, W, T, radius = 16, 32, 24, 4
    X, w, w0 = _problem(3, T, H, W, radius, bias=0.05)
    if not intercept:
        w0 = np.zeros_like(w0)
    wj, wt = _weights(w, w0)
    want = np.asarray(apply_ring_mxu(ring_dense_bands(wj, H, W, radius),
                                     jnp.asarray(w0), jnp.asarray(X), H, W,
                                     radius, interpret=True))
    got = rk.apply_ring_mxu_reference(
        rk.ring_dense_bands(wt, H, W, radius), torch.tensor(w0),
        torch.tensor(X), H, W, radius).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


def test_banded_references_track_f32_stencil():
    """Both banded plain versions equal the f32 stencil up to bf16 operand
    rounding (``tests/test_pallas_ring.py``'s 2e-2 of scale), and agree
    with each other to f32 summation order."""
    H, W, T, radius = 12, 20, 10, 3
    X, w, w0 = _problem(4, T, H, W, radius, bias=0.05)
    _, wt = _weights(w, w0)
    Xt = torch.tensor(X)
    ref = rk.apply_ring_stencil_reference(wt.w, wt.w0, Xt, H, W, radius)
    bands = rk.ring_dense_bands(wt, H, W, radius)
    flat = rk.apply_ring_mxu_flat_reference(bands, wt.w0, Xt, H, W, radius)
    htw = rk.apply_ring_mxu_reference(bands, wt.w0, Xt, H, W, radius)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(flat.numpy() / scale, ref.numpy() / scale,
                               atol=2e-2)
    np.testing.assert_allclose(htw.numpy() / scale, flat.numpy() / scale,
                               atol=1e-6)


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("H,W,radius", [(24, 20, 4), (11, 17, 3)])
def test_dispatching_apply_ring_matches_jax(intercept, H, W, radius):
    X, w, w0 = _problem(5, 6, H, W, radius)
    wj, wt = _weights(w, w0)
    want = np.asarray(ring_apply_auto(wj, jnp.asarray(X), H, W, radius,
                                      include_intercept=intercept))
    got = tring.apply_ring(wt, torch.tensor(X), H, W, radius,
                           include_intercept=intercept).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reconstruct_ring_background_ssub1_matches_jax():
    rng = np.random.default_rng(6)
    T, H, W, K, radius = 12, 20, 24, 3, 4
    X, w, w0 = _problem(6, T, H, W, radius, scale=0.01, bias=0.02)
    Y = X + 2.0
    A = np.abs(rng.standard_normal((K, H, W))).astype(np.float32)
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    b0 = rng.standard_normal((H, W)).astype(np.float32)
    wj, wt = _weights(w, w0)
    want = np.asarray(jring.reconstruct_ring_background(
        wj, jnp.asarray(Y), jnp.asarray(A), jnp.asarray(C),
        jnp.asarray(b0), radius, ssub=1))
    got = tring.reconstruct_ring_background(
        wt, torch.tensor(Y), torch.tensor(A), torch.tensor(C),
        torch.tensor(b0), radius, ssub=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_stencil_tile_fits_shared_memory():
    """K6's pixel tile: 8 x 32 at the step's 256 x 256, radius 13; narrower
    FOVs keep 256 pixels; many taps shrink it into shared memory."""
    assert rk._stencil_tile(256, 256, 92, 13) == (8, 32)
    assert rk._stencil_tile(20, 13, 40, 6) == (19, 13)
    assert rk._stencil_tile(5, 7, 28, 4) == (5, 7)
    ht, wt = rk._stencil_tile(512, 512, 400, 60)
    assert ht * wt < 256
    assert (400 * ht * wt + 2 * (ht + 120) * (wt + 120) + 400) * 4 \
        <= rk._SMEM_CAP
    with pytest.raises(ValueError):
        rk._stencil_tile(512, 512, 60000, 200)


def test_banded_kernels_refuse_unaligned_width():
    """The banded kernels load 16-byte rows: W % 8 != 0 raises before any
    launch (the plain versions take any W)."""
    H, W, T, radius = 4, 12, 3, 2
    D = 2 * radius + 1
    Xp = torch.zeros((T, (H + D - 1) * W), dtype=torch.bfloat16)
    bands = torch.zeros((H, D * W, W), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="W % 8"):
        rk._banded("ring_banded_flat", Xp, bands, torch.zeros(H * W), T, H,
                   W, radius)


# --------------------------------------------------------------------- #
# the geometry of the CUDA kernels, which the CPU reaches
# --------------------------------------------------------------------- #
_CSRC = Path(rk.__file__).resolve().parents[1] / "csrc"


def _constexpr(source, name):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (_CSRC / source).read_text())
    assert m, f"{source} has no constexpr int {name}"
    return int(m.group(1))


def test_kernel_constants_match_the_sources():
    """The Python geometry and the CUDA sources use the same tiles."""
    st = "ring_stencil.cu"
    assert rk._REGS_TILE == (_constexpr(st, "kHT"), _constexpr(st, "kWT"))
    assert rk._REGS_STAGES == _constexpr(st, "kStages")
    assert rk._REGS_WIDE_TAPS == _constexpr(st, "kWideTaps")
    assert rk._REGS_FRAMES == (_constexpr(st, "kFNarrow"),
                               _constexpr(st, "kFWide"))
    assert rk._REGS_MAX_RADIUS == _constexpr(st, "kMaxRegRadius")
    assert (rk._BAND_TN, rk._BAND_KB) == tuple(
        _constexpr("ring_banded.cu", n) for n in ("TN", "KB"))


@pytest.mark.parametrize("radius", range(1, 15))
def test_register_body_taps_follow_ring_offsets(radius):
    """The register body compiles each ring's taps from the integer rule
    radius^2 <= dy^2 + dx^2 < (radius + 1)^2, dy outer and dx inner, both
    ascending; the weights come in ring_offsets' order, so the two must be
    the same list."""
    r = radius + 1
    taps = [(y, x) for y in range(-r, r + 1) for x in range(-r, r + 1)
            if radius ** 2 <= y * y + x * x < (radius + 1) ** 2]
    np.testing.assert_array_equal(np.array(taps), rk.ring_offsets(radius))


@pytest.mark.parametrize("T,H,W,radius,body,frames", [
    (2000, 256, 256, 13, "registers", 8),     # the step
    (2000, 128, 128, 9, "registers", 4),      # the fit's coarse grid
    (2000, 256, 256, 14, "registers", 8),     # the widest compiled ring
    (2000, 256, 256, 15, "shared", 1),        # past the register cap
    (300, 100, 200, 13, "registers", 8),      # W, H off the 8 x 32 tile
    (60, 37, 131, 9, "shared", 1),            # W % 4 != 0
    (7, 64, 96, 13, "registers", 8),
    (1, 24, 24, 13, "registers", 8),          # W <= 2 mr
    (30, 40, 64, 6.5, "shared", 1),           # not an integer radius
    (9, 16, 32, 1, "registers", 4),
    (30, 512, 512, 60, "shared", 1),
])
def test_stencil_plan_picks_body_and_fits_shared_memory(T, H, W, radius,
                                                        body, frames):
    """K6's picker: the body each shape takes, the frames a thread sums,
    frames a CTA that cover T in whole groups, and shared memory within
    what a Hopper CTA can have."""
    plan = rk._stencil_plan(T, H, W, radius, 132)
    assert (plan.body, plan.frames_per_thread) == (body, frames)
    assert plan.smem_bytes <= rk._SMEM_CAP
    if body == "registers":
        R = rk.ring_offsets(radius).shape[0]
        assert frames == (4 if R <= rk._REGS_WIDE_TAPS else 8)
        assert plan.TT % frames == 0 and plan.TT >= frames
        assert rk._cdiv(T, plan.TT) * plan.TT >= T
        tiles = rk._cdiv(H, 8) * rk._cdiv(W, 32) * rk._cdiv(T, plan.TT)
        assert tiles <= max(2 * 132, rk._cdiv(H, 8) * rk._cdiv(W, 32))
    else:
        assert (plan.HT, plan.WT) == rk._stencil_tile(
            H, W, rk.ring_offsets(radius).shape[0],
            int(np.abs(rk.ring_offsets(radius)).max()))


def test_register_cap_is_the_shared_memory_of_a_cta():
    """Radius 14 is the widest ring whose register-body halos fit a CTA
    (3 stages of 8 frames); radius 15's would not."""
    HT, WT = rk._REGS_TILE
    frames = rk._REGS_FRAMES[1]

    def halos(rad):
        return rk._REGS_STAGES * (frames * (HT + 2 * rad)
                                  * (WT + 2 * rk._cdiv(rad, 4) * 4) * 4 + 8)
    assert halos(rk._REGS_MAX_RADIUS) <= rk._SMEM_CAP
    assert halos(rk._REGS_MAX_RADIUS + 1) > rk._SMEM_CAP


_BLOCK_CASES = [(4, 256, 13), (6, 128, 9), (5, 200, 13), (3, 200, 9),
                (4, 24, 4), (3, 40, 9), (20, 8, 13), (7, 72, 3)]


@pytest.mark.parametrize("H,W,radius", _BLOCK_CASES)
def test_banded_k_blocks_cover_every_tap(H, W, radius):
    """Every nonzero of ring_dense_bands lies in a block that K5's list
    holds for its column tile; the lists are ascending, unique, aligned and
    inside the band."""
    R = rk.ring_offsets(radius).shape[0]
    rng = np.random.default_rng(radius * 100 + W)
    w = (1.0 + rng.random((H * W, R))).astype(np.float32)
    bands = rk.ring_dense_bands(RingWeights(w=torch.tensor(w),
                                            w0=torch.zeros(H * W)),
                                H, W, radius)
    kstart, koff = rk.banded_k_blocks(radius, W)
    tn, kb = rk._BAND_TN, rk._BAND_KB
    D = 2 * int(np.abs(rk.ring_offsets(radius)).max()) + 1
    assert len(koff) == rk._cdiv(W, tn) + 1 and koff[0] == 0
    listed = set()
    for j in range(len(koff) - 1):
        blocks = kstart[koff[j]:koff[j + 1]]
        assert np.all(np.diff(blocks) > 0) and np.all(blocks % kb == 0)
        assert blocks.min() >= 0 and blocks.max() < D * W
        listed |= {(b // kb, j) for b in blocks}
    _, k, n = np.nonzero(bands.float().numpy())
    assert len(k) > 0
    assert {(kk // kb, nn // tn) for kk, nn in zip(k, n)} <= listed
    # at the step's shape the list skips most of the band
    if (W, radius) == (256, 13):
        assert len(kstart) * kb * tn < 0.4 * D * W * W


@pytest.mark.parametrize("H,W,radius", _BLOCK_CASES[:6])
def test_product_over_listed_blocks_equals_reference(H, W, radius):
    """K5's arithmetic on the CPU: per column tile, the product over the
    listed blocks alone, A read from the unpadded movie with rows outside
    [0, H) as zeros, as the kernel reads it, equals the plain version to
    1e-6 of the output's scale."""
    T = 9
    X, w, w0 = _problem(7, T, H, W, radius, bias=0.05)
    _, wt = _weights(w, w0)
    bands = rk.ring_dense_bands(wt, H, W, radius).float()
    Xb = rk._bf16_f32(torch.tensor(X)).reshape(T, H * W)
    mr = int(np.abs(rk.ring_offsets(radius)).max())
    DW = (2 * mr + 1) * W
    kstart, koff = rk.banded_k_blocks(radius, W)
    tn, kb = rk._BAND_TN, rk._BAND_KB
    out = torch.zeros((T, H, W))
    for h in range(H):
        for j in range(len(koff) - 1):
            n0, n1 = j * tn, min(j * tn + tn, W)
            for k0 in kstart[koff[j]:koff[j + 1]]:
                ks = torch.arange(int(k0), min(int(k0) + kb, DW))
                a = (h - mr) * W + ks
                inside = (a >= 0) & (a < H * W)
                A = torch.zeros((T, len(ks)))
                A[:, inside] = Xb[:, a[inside]]
                out[:, h, n0:n1] += A @ bands[h, ks, n0:n1]
    out += torch.tensor(w0).reshape(1, H, W)
    want = rk.apply_ring_mxu_flat_reference(
        rk.ring_dense_bands(wt, H, W, radius), torch.tensor(w0),
        torch.tensor(X), H, W, radius)
    scale = float(want.abs().max())
    np.testing.assert_allclose(out.numpy() / scale, want.numpy() / scale,
                               atol=1e-6)
