"""The benchmark's mesh cell (``round_1p_ring_k2000_mesh4``) on the CPU,
cut to 64 x 64 x 400 with 16 neurons, as the harness runs it
(``benchmark/harness/session.py``, whose ``run`` refuses a process that
has loaded JAX, as this suite's does): the cell's entry
(``benchmark/entries/mesh_round.py``: the port's round on a 2 x 2 mesh
of gloo ranks that stay up between rounds, one spawn for the module)
held to its blocked plain reference (``benchmark/references/
mesh_round.py``) within the tolerances below, each fault of
``tests/mesh_round_faults.py`` planted on the same ranks not correct
under the cell's limits, and that reference held to the unblocked one
(``references/update_round.py``) within rounding.
"""

import json

import mesh_round_faults as faults
import pytest
import torch

from benchmark.entries import mesh_round as entry
from benchmark.entries import update_round as one_card
from benchmark.harness import inputs, judge, spec
from benchmark.references import mesh_round as blocked
from benchmark.references import update_round as unblocked
from benchmark.tests.tiny import tiny_root

torch.set_num_threads(1)

CELL = "round_1p_ring_k2000_mesh4"
SEED = 2 ** 31 + 23
SIZE = dict(H=64, W=64, T=400, K=16)

# The mesh sums the products over its 'frame' ranks and the reference
# over its blocks of frames, so the two round apart. The ring's
# intercept w0 is the regression's rounding-level offset of a centred
# residual (its norm a millionth of w's), so it is judged by the
# background it predicts (B, Bdyn) and not on its own.
TOLERANCE = {"B_max": 1e-6, "Bdyn_max": 1e-4, "b0_fro": 1e-6,
             "w_fro": 1e-3, "A_med": 1e-5, "A_max": 1e-5,
             "C_raw_max": 1e-4, "C_max": 1e-4, "S_max": 1e-4}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("mesh_round"), **SIZE)


@pytest.fixture(scope="module")
def cell_inputs(root):
    cell = spec.load(CELL, root)
    Y, start, sn = inputs.make_inputs(cell.config, cell.traffic, SEED,
                                      "cpu", blocked)
    rows, frames = inputs.check_sample(cell.config, cell.traffic,
                                       cell.limits, SEED)
    return cell, Y, start, sn, rows, frames


@pytest.fixture(scope="module")
def run(cell_inputs):
    """The entry's rounds as ``session.run`` makes them (a warm-up round
    that ships the blocks, a round in the window, the outputs), and the
    check's numbers against the blocked reference; before the window's
    round, on the same ranks, each fault of ``tests/mesh_round_faults.py``
    in a round of its own and its verdict under the cell's limits."""
    cell, Y, start, sn, rows, frames = cell_inputs
    params = cell.config["params"]
    ref = blocked.run_round(Y, start, sn, params, rows)
    A0 = start["A"] * start["active"][:, None, None]
    C0 = start["C"] * start["active"][:, None]

    def judged(prog):
        B = [blocked.background_frames(o, Y, A0, C0, frames,
                                       params["background"],
                                       blocked.Precision())
             for o in (prog, ref)]
        return judge.numbers(prog, ref, *B)

    p = entry.params(cell.config)
    st0 = entry.start_state(start, p)
    ranks = entry._MESH["mesh"]
    entry.round_(Y, st0, p, sn)
    verdicts = {}
    for fault in faults.FAULTS:
        ranks.call(faults.faulty_round, fault)
        nums = judged(ranks.call(entry._gather, rows))
        verdicts[fault] = judge.verdict(nums, cell.limits["limits"])
    out = entry.round_(Y, st0, p, sn)
    prog = entry.outputs(out, rows)
    return ranks, judged(prog), verdicts


def test_the_mesh_round_matches_its_reference(run):
    _, nums, _ = run
    for k, tol in TOLERANCE.items():
        assert nums[k] <= tol, (k, nums[k], tol)


def _over(checks):
    return {k for k, c in checks.items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_mesh_faults_are_not_correct(cell_inputs, run, fault):
    """Each fault, planted on every rank, fails a limit of the cell that
    the sound round meets at this size (where the ring's intercept w0 is
    a rounding-level offset, the TOLERANCE note above); a fault of the
    exchange between ranks fails one of what it feeds."""
    _, nums, verdicts = run
    _, sound = judge.verdict(nums, cell_inputs[0].limits["limits"])
    correct, checks = verdicts[fault]
    assert not correct
    over = _over(checks) - _over(sound)
    assert over, checks
    fed = {"ring_halo_left_out": {"B_max", "Bdyn_max", "w_fro"},
           "frame_psum_skipped": {"A_med", "A_max"}}.get(fault)
    assert fed is None or over & fed, checks


def test_outputs_close_the_mesh(run):
    ranks, _, _ = run
    assert ranks.backend == "gloo" and ranks.alive() == []
    assert entry._MESH == {} and entry._HELD == {}
    with pytest.raises(RuntimeError, match="closed"):
        ranks.call(entry._round)


@pytest.mark.parametrize("block", [7, 64, 400])
def test_the_blocked_reference_rounds_as_the_unblocked(cell_inputs, block):
    cell, Y, start, sn, rows, _ = cell_inputs
    params = cell.config["params"]
    ref = unblocked.run_round(Y, start, sn, params, rows)
    out = blocked.run_round(Y, start, sn, params, rows, block=block)
    for k in ("w", "b0", "A", "C_raw", "C", "S"):
        err = float((out[k] - ref[k]).norm() / ref[k].norm())
        assert err <= 1e-5, (k, err)
    assert float((out["w0"] - ref["w0"]).norm()) <= 1e-5 * float(
        ref["w"].norm())
    if block >= Y.shape[0]:             # one block: the unblocked round
        for k in ref:
            assert torch.equal(out[k], ref[k]), k


def test_the_control_is_not_correct(cell_inputs):
    """The reference with TF32 products, in the program's place, fails
    the cell's limits."""
    cell, Y, start, sn, rows, frames = cell_inputs
    params = cell.config["params"]
    p = one_card.params(cell.config)
    st = one_card.start_state(start, p)
    out = entry.control_round(blocked, params, rows)(Y, st, p, sn)
    prog = entry.outputs(out, rows)
    ref = blocked.run_round(Y, start, sn, params, rows)
    A0 = start["A"] * start["active"][:, None, None]
    C0 = start["C"] * start["active"][:, None]
    bg = params["background"]
    B = [blocked.background_frames(o, Y, A0, C0, frames, bg,
                                   blocked.Precision()) for o in (prog, ref)]
    correct, _ = judge.verdict(judge.numbers(prog, ref, *B),
                               cell.limits["limits"])
    assert not correct


def test_the_entry_takes_the_mesh_from_the_configuration(root):
    cell = spec.load(CELL, root)
    p = entry.params(cell.config)
    assert (p.patch.n_patch, p.patch.n_frame) == (2, 2)
    assert json.loads(p.to_json())["background"] == \
        cell.config["params"]["background"]
    svd = dict(spec.load("round_2p_svd_k1000", root).config,
               mesh=cell.config["mesh"])
    with pytest.raises(ValueError, match="ring"):
        entry.params(svd)
    changed = json.loads(json.dumps(cell.config))
    changed["params"]["spatial"]["n_iter"] = 3
    with pytest.raises(ValueError, match="preset_1p"):
        entry.params(changed)


def test_frame_blocks_bound_the_reference():
    Y = torch.empty((10, 4, 8))
    assert blocked.frame_block(Y) == 10
    big = torch.empty((1, 512, 512)).expand(24000, 512, 512)
    assert blocked.frame_block(big) == 1024
