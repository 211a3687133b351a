"""The port's data-parallel detector step against the JAX package's mesh
step, on the CPU: two ranks over gloo (``tests/torch_parallel_worker.py``
``yolo``) each take 4 of 8 images, yolov5 (depth 0.33, width 0.25, nc 3)
at 64x64 with ``accumulate=2``, past warm-up, with the global batch
statistics and positive count; JAX's ``YoloTrainer(mesh=make_mesh(2))``
takes the 8.  The ranks run while JAX compiles its step.

Bounds: the loss within 2e-6 relative (``tests/test_multiproc.py``'s);
the step within the detector trainer's bounds
(``tests/test_torch_yolo_train.py`` ``_check_step``): every weight within
1e-6 plus the SGD move of the two sides' gradient difference, momenta
and EMA likewise, the running statistics within 1e-5, and the ranks'
averaged gradient within 1e-3 in norm of the port's float64 gradient of
the same micro-batches.  JAX's gradient is read from its momenta (one
step from zero momentum: the gradient plus the weight decay it added)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lpr_tpu.models import yolo as jy
from lpr_tpu.parallel import mesh as jmesh
from lpr_tpu.train import yolo as jyt
from lpr_tpu_torch.models import yolo as ty
from lpr_tpu_torch.train import yolo as tyt
from lpr_tpu_torch.weights.checkpoint import params_from_jax

from .test_torch_parallel import (ACC, LOSS_RTOL, STEP0, _inputs, _sub,
                                  _yolo_spec, join_ranks, spawn_ranks)
from .test_torch_yolo_train import _check_step, _t_spec
from .train_ref import jax_tree, one_torch_thread  # noqa: F401


def test_yolo_two_ranks_match_jax_mesh_step(tmp_path):
    root = str(tmp_path)
    inp = _inputs()
    np.savez(os.path.join(root, "inputs.npz"), **inp)
    procs = spawn_ranks(root, ["yolo"])
    try:
        spec = _yolo_spec()
        jm = jy.build_yolo(spec, strides=(8, 16, 32))
        flat = {k[5:]: v for k, v in inp.items() if k.startswith("yolo/")}
        x, lab = inp["yolo_x0"], inp["yolo_lab0"]
        jtr = jyt.YoloTrainer(jm, jyt.YoloTrainConfig(), steps_per_epoch=10,
                              mesh=jmesh.make_mesh(2), accumulate=ACC)
        jstate = jtr.init(params=jax_tree(jm.init, flat))
        jstate["step"] = jnp.int32(STEP0)
        jstate, jtot, _ = jtr.step(jstate, jnp.asarray(x), jnp.asarray(lab))
        jstate = {part: jax.device_get(jstate[part])
                  for part in ("params", "momenta", "ema")}
    finally:
        got = join_ranks(procs, root)
    assert abs(float(got[0]["yolo_loss0"]) - float(jtot)) <= \
        LOSS_RTOL * abs(float(jtot))

    tm = ty.build_yolo(_t_spec(spec), strides=(8, 16, 32))
    ttr = tyt.YoloTrainer(tm, tyt.YoloTrainConfig(), steps_per_epoch=10,
                          accumulate=ACC, device="cpu")
    wd = ttr.cfg.weight_decay
    mom = params_from_jax(jstate["momenta"])
    jstate["_grads"] = {k: m - wd * flat[k] if tyt._is_conv_weight(k)
                        else m for k, m in mom.items()}
    t_state = {part: {k: torch.from_numpy(v)
                      for k, v in _sub(got[0], f"yolo_{part}/").items()}
               for part in ("params", "momenta", "ema")}
    _check_step(tm, flat, x, lab, jstate, t_state, ttr, STEP0,
                grads=_sub(got[0], "yolo_g/"))
