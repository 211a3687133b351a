"""The port's PlateRecognizer with a two-device CPU mesh (two replicas,
the batch split, the outputs concatenated) against the JAX package's
``PlateRecognizer(mesh=make_mesh(2))`` and against its unsharded self,
on the repo's checkpoints at detector 192x320, float32.

Bounds: against JAX the slice's (``tests/test_torch_recognizer.py``
``compare``: validity, classes and strings equal, boxes within 0.5 px, SR
within 1e-2, since eager ops against one XLA program move SR pixels by up
to ~3e-3); against the unsharded port ``tests/test_pipeline.py:133-160``'s
validity and boxes within 1e-3 px, with the strings equal and SR within
the slice's 1e-2: oneDNN picks its convolution algorithm by batch size,
so a replica's batch of 1 rounds apart from the batch of 2 and moves
crop pixels on sharp plate edges as the JAX comparison does."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.parallel import mesh as jmesh
from lpr_tpu.pipeline import recognizer as jrec
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as ty
from lpr_tpu_torch.parallel import mesh as tmesh
from lpr_tpu_torch.pipeline import recognizer as trec

from . import torch_ref
from .test_torch_recognizer import CHAR, LPSR, PLATE, compare, synth_frames

DET_HW = (192, 320)


def _port(mesh):
    tchar, _, ck = ty.load_char_ocr_npz(CHAR, device="cpu")
    return trec.PlateRecognizer(
        ty.load_plate_detector(PLATE, device="cpu"), tchar,
        tlpsr.load_lpsr(LPSR, device="cpu"),
        trec.PipelineConfig(det_hw=DET_HW, dtype=torch.float32),
        char_names=ck.names, device="cpu", mesh=mesh)


def test_mesh_recognizer_matches_jax_mesh_and_its_unsharded_self():
    frames = synth_frames(2, (180, 320), seed=3)
    plate, pp = torch_ref.plate()
    char, cp, names = torch_ref.char()
    jr = jrec.PlateRecognizer(
        plate, pp, char, cp, torch_ref.lpsr(), jlpsr.LPSRConfig(),
        jrec.PipelineConfig(det_hw=DET_HW, dtype=jnp.float32),
        char_names=names, mesh=jmesh.make_mesh(2))
    tr = _port(tmesh.make_mesh(2))
    assert isinstance(tr, trec.ShardedRecognizer)
    assert [type(r) for r in tr.replicas] == [trec.PlateRecognizer] * 2
    assert tr.replicas[0].plate_model is not tr.replicas[1].plate_model
    with pytest.raises(ValueError, match="does not split"):
        tr.step_raw(np.repeat(frames[:1], 3, 0))
    results = compare(jr, tr, frames)
    assert sum(len(f) for f in results) >= 2

    one = _port(None)
    o1 = trec.to_host(one.step_raw(frames))
    o2 = trec.to_host(tr.step_raw(frames))
    np.testing.assert_array_equal(o2["plate_valid"], o1["plate_valid"])
    np.testing.assert_allclose(o2["plate_boxes"], o1["plate_boxes"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(o2["sr"], o1["sr"], rtol=0, atol=1e-2)
    assert ([[(p["text"], p["text_sr"]) for p in f]
             for f in tr.assemble(o2)]
            == [[(p["text"], p["text_sr"]) for p in f]
                for f in one.assemble(o1)])


def test_sharded_recognizer_tool_on_cpu(capsys):
    """``tools/sharded_recognizer`` on the CPU: two replicas, every output
    equal to the plain recognizer's on the same shares inside the tool,
    and in float32 the whole batch's plates with the boxes within 1e-3 px
    (``tests/test_pipeline.py:133-160``'s bound), one JSON line."""
    from lpr_tpu_torch.tools import sharded_recognizer

    assert sharded_recognizer.main(["--device", "cpu", "--batch", "2",
                                    "--batches", "1", "--steps", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["devices"] == ["cpu", "cpu"] and res["plates"] > 0
    assert res["whole_batch"]["slots_apart"] == 0
    assert res["whole_batch"]["box_max_abs_err"] <= 1e-3
