"""The check on the CPU at a tiny size: the plain reference computes the
port's round, the control (the reference with TF32 products) and every
fault a cell can have come out not correct, and the TF32 rounding is
TF32's."""

import time

import numpy as np
import pytest
import torch

from benchmark.entries import update_round as entry
from benchmark.harness import inputs, judge, session, spec
from benchmark.references import update_round as ref
from benchmark.tests.tiny import tiny_root
from cnmf_e_tpu_torch.models.background import (subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.temporal import update_temporal

CELLS = ("round_1p_ring_k2000", "round_2p_svd_k1000")
SEED = 2 ** 31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, round_fn=None):
    res, _, _ = session.run(cell, SEED, 0.01, False, time.perf_counter(),
                         device="cpu", round_fn=round_fn, root=root)
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_reference_computes_the_ports_round(root, cell):
    """Both backgrounds: every number of the check, compared or not, at
    the float32 rounding level, and the run correct."""
    c = spec.load(cell, root)
    Y, start, sn = inputs.make_inputs(c.config, c.traffic, SEED, "cpu", ref)
    rows, frames = inputs.check_sample(c.config, c.traffic, c.limits, SEED)
    p = entry.params(c.config)
    prog = entry.outputs(entry.round_(Y, entry.start_state(start, p), p,
                                      sn), rows)
    out = ref.run_round(Y, start, sn, c.config["params"], rows)
    A0 = start["A"] * start["active"][:, None, None]
    C0 = start["C"] * start["active"][:, None]
    bg = c.config["params"]["background"]
    B = [ref.background_frames(o, Y, A0, C0, frames, bg, ref.Precision())
         for o in (prog, out)]
    nums = judge.numbers(prog, out, *B)
    assert max(nums.values()) < 1e-5, nums
    assert _run(root, cell)["correct"] is True


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.0 - 2 ** -9 + 2 ** -12, 0.0])
    # nearest, ties to even, at 10 mantissa bits
    assert ref.to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9,
                                       -3.0 - 2 ** -9, 0.0]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The reference with TF32 products in the program's place, under the
    timed path, fails the cell's limits (at the cell's size its readings
    are in PERF.md)."""
    c = spec.load(cell, root)
    rows, _ = inputs.check_sample(c.config, c.traffic, c.limits, SEED)
    res = _run(root, cell, round_fn=entry.control_round(
        ref, c.config["params"], rows))
    assert res["correct"] is False
    assert sum(v["value"] > v["limit"]
               for v in res["checks"].values()) >= 3


def unchanged(Y, st, p, sn_pix, stage=None):
    """A round that returns its state unchanged."""
    return st


def half_frames(Y, st, p, sn_pix, stage=None):
    """The footprints fitted on half of the frames, their means taken
    over those."""
    st = update_background(Y, st, p, sn_pix=sn_pix)
    Ysig = subtract_background(Y, st, p)
    h = Y.shape[0] // 2
    A = update_spatial(Ysig[:h], st.replace(C=st.C[:, :h]), p,
                       sn_pix=sn_pix).A
    return update_temporal(Ysig, st.replace(A=A), p)


def one_footprint_altered(Y, st, p, sn_pix, stage=None):
    """One neuron's footprint altered where the spatial update makes it."""
    st = update_background(Y, st, p, sn_pix=sn_pix)
    Ysig = subtract_background(Y, st, p)
    st = update_spatial(Ysig, st, p, sn_pix=sn_pix)
    A = st.A.clone()
    A[0] *= 1.5
    return update_temporal(Ysig, st.replace(A=A), p)


def spikes_altered(Y, st, p, sn_pix, stage=None):
    """The deconvolution's answer altered where it is made: every spike
    1% larger."""
    st = entry.round_(Y, st, p, sn_pix)
    return st.replace(S=st.S * 1.01)


def one_trace_altered(Y, st, p, sn_pix, stage=None):
    """One neuron's deconvolution altered where it is made, as a fault in
    one block of the solve would: its spikes 10% larger. The medians
    over the sampled traces do not see it; the worst trace does."""
    st = entry.round_(Y, st, p, sn_pix)
    S = st.S.clone()
    S[0] *= 1.1
    return st.replace(S=S)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_frames,
                                   one_footprint_altered, spikes_altered,
                                   one_trace_altered])
def test_faults_are_not_correct(root, cell, fault):
    """Each fault the round can have, under the timed path: correct comes
    out false. (One chip: no exchange between chips to leave out.)"""
    res = _run(root, cell, round_fn=fault)
    assert res["correct"] is False and res["failed"] == 1


def test_sample_is_drawn_from_the_seed():
    c = spec.load("round_1p_ring_k2000")
    a = inputs.check_sample(c.config, c.traffic, c.limits, 11)
    b = inputs.check_sample(c.config, c.traffic, c.limits, 11)
    d = inputs.check_sample(c.config, c.traffic, c.limits, 12)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], d[0])
    assert len(a[0]) == c.limits["sample_rows"] and len(np.unique(a[0])) \
        == len(a[0])


def test_inputs_are_the_seeds(root):
    c = spec.load("round_1p_ring_k300", root)
    Y1, s1, n1 = inputs.make_inputs(c.config, c.traffic, 99, "cpu", ref)
    Y2, s2, n2 = inputs.make_inputs(c.config, c.traffic, 99, "cpu", ref)
    Y3, _, _ = inputs.make_inputs(c.config, c.traffic, 100, "cpu", ref)
    assert torch.equal(Y1, Y2) and torch.equal(s1["A"], s2["A"])
    assert torch.equal(n1, n2) and not torch.equal(Y1, Y3)
    assert int((s1["A"].amax(dim=(1, 2)) > 0).sum()) == c.traffic["K"]


def test_tf32_products_in_blocks(monkeypatch):
    """A large operand rounded in blocks gives the product of the whole
    operands rounded."""
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn((6, 40), generator=g), torch.randn((40, 50),
                                                          generator=g)
    whole = ref.to_tf32(a) @ ref.to_tf32(b)
    monkeypatch.setattr(ref.Precision, "BLOCK", 200)
    P = ref.Precision(tf32=True)
    torch.testing.assert_close(P.mm(a, b), whole, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(P.mm(b.T, a.T), whole.T, rtol=1e-6,
                               atol=1e-6)
