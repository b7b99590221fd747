"""What the harness and the reference load, each in a process of its own:
no module whose top-level name (the part before the first dot, compared
whole) is ``jax``, ``jaxlib``, ``flax`` or ``cnmf_e_tpu`` (the JAX
package, whose name the port's begins with); and the reference loads
nothing of ``cnmf_e_tpu_torch`` either."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import session, spec

JAX = set(session.FORBIDDEN)

HARNESS = """
import json, sys, time
from pathlib import Path
from benchmark.harness import session
from benchmark.tests.tiny import tiny_root
res, _, _ = session.run("round_1p_ring_k300", 3, 0.01, False,
                     time.perf_counter(), device="cpu",
                     root=tiny_root(Path(sys.argv[1])))
assert res["correct"]
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import numpy as np, torch
from benchmark.references import update_round as ref
from benchmark.harness import inputs, judge
from benchmark.harness import spec
from pathlib import Path
from benchmark.tests.tiny import tiny_root
c = spec.load("round_2p_svd_k1000", tiny_root(Path(sys.argv[1])))
Y, start, sn = inputs.make_inputs(c.config, c.traffic, 5, "cpu", ref)
rows, frames = inputs.check_sample(c.config, c.traffic, c.limits, 5)
out = ref.run_round(Y, start, sn, c.config["params"], rows)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

PORT = """
import json, sys
import cnmf_e_tpu_torch
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.models import batch, streaming, cnmf2p
from cnmf_e_tpu_torch import run
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _modules(code, tmp_path):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=spec.ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("what", ["harness", "reference", "port"])
def test_no_jax(tmp_path, what):
    code = {"harness": HARNESS, "reference": REFERENCE, "port": PORT}[what]
    mods = _modules(code, tmp_path)
    assert not mods & JAX, sorted(mods & JAX)
    if what == "reference":
        assert "cnmf_e_tpu_torch" not in mods
    else:
        assert "cnmf_e_tpu_torch" in mods


def test_whole_names_are_compared(monkeypatch):
    """The port's name begins with the JAX package's: it passes, the JAX
    package itself is refused."""
    me = sys.modules[__name__]
    monkeypatch.delitem(sys.modules, "cnmf_e_tpu", raising=False)
    monkeypatch.setitem(sys.modules, "cnmf_e_tpu_torch_x", me)
    monkeypatch.setitem(sys.modules, "cnmf_e_tpu_torch.models", me)
    assert not {"cnmf_e_tpu_torch", "cnmf_e_tpu_torch_x"} & set(
        session.forbidden_modules())
    monkeypatch.setitem(sys.modules, "cnmf_e_tpu.ops", me)
    assert "cnmf_e_tpu" in session.forbidden_modules()
    with pytest.raises(SystemExit) as e:
        session.refuse_forbidden("a test")
    assert e.value.code == 3
