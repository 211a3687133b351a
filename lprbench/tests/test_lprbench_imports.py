"""What the harness loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``lpr_tpu`` (compared whole: ``lpr_tpu_torch``
begins with ``lpr_tpu``), after a whole run at a tiny size on the CPU; and
the reference, with the comparison, the frames and the work arithmetic,
loads nothing of ``lpr_tpu_torch``."""

import subprocess
import sys

from lprbench.tests.conftest import ROOT

RUN = """
import sys
sys.path.insert(0, {root!r})
from lprbench import run
from lprbench.tests.conftest import TINY_MIX, config, manifest, tiny
cfg = tiny(config())
run.run_cell(manifest(), "lpr720.closed64", 5, 2.0, True, device="cpu",
             cfg_changes={{k: cfg[k] for k in ("frame_hw", "pipeline")}},
             mix_changes=TINY_MIX)
print(" ".join(sorted(sys.modules)))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import lprbench.check, lprbench.frames, lprbench.load, lprbench.trace
import lprbench.ref.pipeline, lprbench.work.model_flops
import lprbench.work.k1_front, lprbench.work.k2_lpsr
print(" ".join(sorted(sys.modules)))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=600, cwd=str(ROOT))
    return set(out.stdout.split("\n")[-2].split())


def test_a_run_loads_no_jax_and_no_jax_package():
    tops = {m.split(".")[0] for m in _modules(RUN)}
    assert "lpr_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "lpr_tpu"}, tops


def test_the_reference_loads_nothing_of_the_program():
    tops = {m.split(".")[0] for m in _modules(REFERENCE)}
    assert not tops & {"lpr_tpu_torch", "lpr_tpu", "jax", "jaxlib",
                       "flax"}, tops
