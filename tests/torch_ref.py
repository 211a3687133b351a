"""JAX-side references for the port's tests (tests/test_torch_*.py): the
repo's checkpoints loaded into the JAX package's models.

``lpr_tpu.weights.checkpoint.load_params`` fills a parameter pytree built by
the model's ``init`` and reads only its structure, shapes and dtypes, so
the tree here is zeros of ``init``'s abstract result (``jax.eval_shape``):
running ``init``, eagerly or compiled, dominated these tests' time.
Loaded once per process and shared read-only."""

import functools

import jax
import numpy as np

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.models import yolo as jyolo
from lpr_tpu.pipeline.chars import OCR_CLASSES
from lpr_tpu.weights.checkpoint import load_params

PLATE = "checkpoints/plate_det640.npz"
CHAR = "checkpoints/char_ocr_synth.npz"
LPSR = "checkpoints/lpsr_synth_glare/best_model.npz"


def _load(path, init):
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(init, jax.random.PRNGKey(0)))
    return load_params(path, like)


@functools.lru_cache(maxsize=None)
def plate():
    """(model, params) of the plate detector, as bench.py loads it."""
    model = jyolo.build_yolo(jyolo.yolov5_spec(nc=11), strides=(8, 16, 32))
    return model, _load(PLATE, model.init)


@functools.lru_cache(maxsize=None)
def char():
    """(model, params, names) as ``lpr_tpu.models.yolo.load_char_ocr_npz``
    builds them."""
    anchors = np.asarray(np.load(CHAR)["__anchors__"], np.float32)
    model = jyolo.build_yolo(jyolo.char_ocr_spec(), ckpt_anchors=anchors,
                             strides=(8,))
    return model, _load(CHAR, model.init), list(OCR_CLASSES)


@functools.lru_cache(maxsize=None)
def lpsr():
    """LPSR params, as ``lpr_tpu.models.lpsr.load_lpsr`` loads an npz."""
    cfg = jlpsr.LPSRConfig()
    return _load(LPSR, lambda k: jlpsr.lpsr_init(k, cfg))
