"""Batched plate recognition: detect -> enhance -> recognize (counterpart of
``lpr_tpu/pipeline/recognizer.py``).

One step over a batch of frames, all on the device: letterbox, the plate
detector (layers 0-2 through the K1 kernel, and layers 3-4 through K3 when
``fused_mid`` is set; with ``int8_detector`` its other convolutions in
int8 through kernels I1 and I2), lazy-decode NMS (or, with
``lazy_decode=False``, the whole grid decoded and ``nms_batched``), the top
plates by area, per-plate
skew estimate and rotated crops (kernel G1 on a card, its plain version's
interpolation matrices on the CPU), the 2-row ->
1-row reshape, LPSR (for the production configuration the K2 kernel on a
card and its plain version on the CPU; any other configuration runs
``LPSR.forward``), the char OCR on the raw crop and on the SR canvas, and
char NMS.  Only the small fixed-shape outputs go to the host, where
:meth:`PlateRecognizer.assemble` builds the strings.

The step keeps the JAX step's cast points: frames are cast to
``cfg.dtype`` and divided by 255, LPSR runs in ``cfg.dtype`` with a
float32 output, the char model gets ``cfg.dtype``.

With ``packed_input`` the host letterboxes the uint8 frames
(:func:`lpr_tpu_torch.ops.image.letterbox_host`) and K1 reads them as
uint8, 1/255 folded into its stem (the JAX package's host-packed input).
With ``freeze_params`` (the default, as in the JAX package, where the
frozen step is one XLA executable with the weights as constants) the
device step runs on a card as one CUDA graph, captured at the first call
of each input shape and replayed after the inputs are copied from pinned
host memory into its static buffers.

With a ``mesh`` (:func:`lpr_tpu_torch.parallel.mesh.make_mesh`),
``PlateRecognizer(..., mesh=)`` returns a :class:`ShardedRecognizer`: one
plain recognizer on each mesh device (its models, K1, K3 and K2 packs and,
with ``freeze_params``, its CUDA graphs; a repeated device holds separate
replicas).  The frame batch (and the letterboxed frames) is split on the
leading axis, each replica's step is issued in turn with its card as the
current device, and the outputs are concatenated on the first device, as
the JAX recognizer's sharded step returns one global batch.  A batch that
does not divide by the mesh's size raises, as JAX's sharded ``jit`` does
(:func:`~lpr_tpu_torch.parallel.mesh.pad_to_multiple` pads one).

Each step leaves a :class:`StepTrace` in ``last_step``: the host times of
its phases, and the stage stamps of its device step (a row of int64
nanoseconds, one stamp before the first of :data:`DEVICE_STAGES` and one
after each).  On a card the stamps are kernels on the step's stream
(``kernels/stamp.py``): captured into the graph in the frozen step, so
every replay writes them, and launched between the stages in the eager
one; either way they time the stages as the card ran them.  On the CPU
they are ``time.perf_counter_ns()``.  The serving layer copies them to the
host with the outputs and sums each stage's time (``serve/server.py``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device
from lpr_tpu_torch.kernels.crop_geometry import compose_crops, plate_crops
from lpr_tpu_torch.kernels.lpsr import lpsr_fused, lpsr_kernel_takes, lpsr_pack
from lpr_tpu_torch.kernels.stamp import calibrate, stamp
from lpr_tpu_torch.models.lpsr import LPSR
from lpr_tpu_torch.models.yolo import YoloModel
from lpr_tpu_torch.ops import image as im
from lpr_tpu_torch.ops.boxes import clip_boxes
from lpr_tpu_torch.ops.nms import nms_batched, nms_from_raw
from lpr_tpu_torch.pipeline.chars import detections_to_string

Tensor = torch.Tensor

PLATE_CLASS_IDS = (7, 8)  # square / rectangle license plate

# The step's stages, in the order PlateRecognizer.step_raw runs them.
# "host letterbox" does its work only with packed_input (and returns None
# without it); the device step is "letterbox+norm" through "char NMS".
STEP_STAGES = ("host letterbox", "upload", "letterbox+norm",
               "plate detector", "plate NMS", "top plates",
               "crop/deskew geometry", "LPSR", "OCR canvases", "char OCR",
               "char NMS")
# The stages a CUDA graph captures, each ended by a stamp (after one at
# the start): the stamps of a step are N_STAMPS times.
DEVICE_STAGES = STEP_STAGES[2:]
N_STAMPS = len(DEVICE_STAGES) + 1

# Eager runs of the device step on a side stream before a capture (cuDNN,
# cuBLAS and the kernels' libraries initialise outside the graph).
GRAPH_WARMUP = 2


def _call(name: str, fn, *args):
    return fn(*args)


@dataclasses.dataclass
class StepTrace:
    """What a step leaves in ``last_step``: ``phases``, (name, start, end)
    in ``perf_counter_ns`` of its host phases (``staging``, ``replay`` or
    ``capture``, ``clone`` in the frozen step; ``staging``, ``replay`` in
    the eager one, whose replay is the stages' launches), and ``stamps``,
    an int64 tensor (replicas, 1 + :data:`N_STAMPS`) whose column 0 is the
    offset from its clock to ``perf_counter_ns`` (:func:`stamp_times`)."""

    phases: Tuple[Tuple[str, int, int], ...]
    stamps: Optional[Tensor]


def stamp_times(stamps) -> Tuple[np.ndarray, np.ndarray]:
    """(the stamps in ``perf_counter_ns`` (R, N_STAMPS), each device
    stage's time in ns (R, len(DEVICE_STAGES))) of a fetched stamps array
    (:class:`StepTrace`)."""
    a = np.asarray(stamps, dtype=np.int64)
    t = a[:, 1:] - a[:, :1]
    return t, np.diff(t, axis=1)


class _Stamper:
    """The ``run`` hook of a stamped device step: a stamp into ``buf``'s
    slot 1 before the first of :data:`DEVICE_STAGES`, and into slot 2 + i
    after stage i, around the hook it wraps (:func:`stamp`: a kernel on a
    card tensor, the host clock on a CPU one)."""

    def __init__(self, buf: Tensor, run: Callable = None):
        self.buf, self.run = buf, run or _call

    def __call__(self, name: str, fn, *args):
        i = DEVICE_STAGES.index(name)
        if i == 0:
            stamp(self.buf, 1)
        out = self.run(name, fn, *args)
        stamp(self.buf, 2 + i)
        return out


def _kernel_counters():
    """(function, attribute) of every launch count the device step can
    move: K1's bf16 and uint8 instances, K3, K2, with int8_detector I1
    (its max pass and its quantize) and I2, and G1."""
    from lpr_tpu_torch.kernels.conv_int8 import (act_amax, conv_int8,
                                                 quantize_act)
    from lpr_tpu_torch.kernels.crop_geometry import plate_crops
    from lpr_tpu_torch.kernels.lpsr import lpsr_fused
    from lpr_tpu_torch.kernels.yolo_front import yolo_front
    from lpr_tpu_torch.kernels.yolo_mid import yolo_mid

    return ((yolo_front, "launches"), (yolo_front, "launches_u8"),
            (yolo_mid, "launches"), (lpsr_fused, "launches"),
            (act_amax, "launches"), (quantize_act, "launches"),
            (conv_int8, "launches"), (plate_crops, "launches"))


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(f, a) for f, a in _kernel_counters())


def _add_counts(delta: Sequence[int]) -> None:
    for (f, a), n in zip(_kernel_counters(), delta):
        setattr(f, a, getattr(f, a) + n)


def _batch_shape(frames) -> Tuple[int, ...]:
    """(B, H, W, 3) of a batch: an array or tensor, or a sequence of B
    frames."""
    if isinstance(frames, (list, tuple)):
        return (len(frames), *(int(n) for n in np.shape(frames[0])))
    return tuple(int(n) for n in frames.shape)


def _concat(trees: Sequence[Any], device: torch.device):
    """Step outputs (dicts of tensors) of the replicas, concatenated on
    the leading axis on ``device``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _concat([t[k] for t in trees], device) for k in first}
    if first is None:
        return None
    return torch.cat([t.to(device) for t in trees], 0)


def _clone(tree):
    """A copy of a step output (dicts of tensors), on the same stream."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


class _Staged:
    """A static device buffer of one step input and two pinned host
    buffers that feed it in turns: a host input is written into the pinned
    buffer whose last copy has finished, then copied with
    ``non_blocking=True``; a device tensor is copied directly."""

    def __init__(self, shape, device: torch.device):
        self.device = torch.empty(shape, dtype=torch.uint8, device=device)
        self._host = [torch.empty(shape, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(2)]
        self._done = [None, None]
        self._turn = 0

    def load(self, a) -> None:
        """Copy ``a`` in: a device tensor directly; a host tensor, a numpy
        batch or a sequence of frames through the pinned buffer, the last
        two gathered by the C letterbox's threads
        (:func:`lpr_tpu_torch.native.gather_into`)."""
        from lpr_tpu_torch import native

        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            self.device.copy_(a)
        elif isinstance(a, torch.Tensor):
            self.fill(lambda host: host.copy_(a))
        else:
            self.fill(lambda host: native.gather_into(a, host))

    def fill(self, write: Callable[[Tensor], Any]) -> None:
        """``write(host)`` fills the pinned buffer whose last copy has
        finished (waited on here), which is then copied in."""
        i, self._turn = self._turn, 1 - self._turn
        if self._done[i] is not None:
            self._done[i].synchronize()
        host = self._host[i]
        write(host)
        self.device.copy_(host, non_blocking=True)
        self._done[i] = torch.cuda.Event()
        self._done[i].record(torch.cuda.current_stream(self.device.device))


@dataclasses.dataclass
class _Graph:
    """One captured device step: its graph, static inputs (frames and, with
    packed_input, the letterboxed frames), outputs, the kernel launches it
    holds (:func:`_kernel_counters` order) and its stamps buffer (column 0
    the clock offset found at capture, the rest written by each replay)."""

    graph: Any
    frames: _Staged
    packed: Optional[_Staged]
    out: Dict[str, Any]
    launches: Tuple[int, ...]
    stamps: Tensor


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    det_hw: Tuple[int, int] = (1280, 1280)
    ocr_hw: Tuple[int, int] = (128, 128)
    sr_hw: Tuple[int, int] = (32, 192)
    det_conf: float = 0.7
    ocr_conf: float = 0.25
    iou: float = 0.3
    max_plates: int = 3
    max_chars: int = 16
    char_pre_topk: int = 64
    long_aspect: float = 1.5
    deskew: bool = True
    dtype: torch.dtype = torch.bfloat16
    # Crops through kernel G1 on a card (kernels/crop_geometry.py), through
    # its plain version's interpolation-matrix products (ops/resample.py) on
    # the CPU; False takes the gather-based reference sampler (ops/image.py
    # crop_rotated).
    fast_geometry: bool = True
    tile_hw: Tuple[int, int] = (64, 256)
    # OCR on both the raw crop and the SR output (reference parity); False
    # reads the SR output only.
    ocr_on_original: bool = True
    # Run the plate detector's layers 0-2 through the K1 kernel
    # (kernels/yolo_front.py).  On a card it needs bf16; det_hw must be
    # multiples of (32, 64).  The recognizer raises on a configuration the
    # kernel cannot take rather than skipping it.
    fused_front: bool = True
    # Extend the fused path through layers 3-4 (kernels/yolo_mid.py, K3).
    # Off by default, as in the JAX package, where the TPU kernel measured a
    # net end-to-end loss at the bench geometry.  Needs fused_front (whose
    # geometry K3 always takes); the recognizer raises without it.
    fused_mid: bool = False
    # Run the device step (letterbox -> char NMS) on a card as one CUDA
    # graph, captured at the first call of each frame shape and replayed:
    # one graph launch and a few copies a step instead of thousands of
    # launches (the counterpart of the JAX package's frozen-weights
    # program).  A capture that fails raises.  On the CPU the eager step
    # runs.  False runs the step eagerly on a card too, which is how to
    # debug it stage by stage.
    freeze_params: bool = True
    # Host-letterboxed detector input: the host letterboxes the uint8
    # frames into the detector's input (ops/image.py letterbox_host) and K1
    # reads them as uint8 with 1/255 folded into its stem (the JAX
    # package's host-packed input, whose TPU layout, the quarter-grid
    # planes, is not carried over: the port's is K1's own NHWC input).
    # Crops still come from the raw frames.  Needs fused_front.
    packed_input: bool = False
    # int8-quantize the plate detector (models/yolo.py quantize_yolo:
    # per-channel int8 weights, BN folded, activations quantized per tensor
    # on the fly; the Detect head stays float).  On a card the quantized
    # convolutions run kernels I1 and I2 (kernels/conv_int8.py).  The
    # detector is quantized after the K1 (and K3) packs are built from its
    # float weights, so layers 0-2 (and 3-4) stay float in those kernels,
    # as on the JAX package's TPU path.  Off by default, as there.
    int8_detector: bool = False
    # Lazy-decode NMS (ops/nms.py nms_from_raw): candidates are selected on
    # the raw Detect logits and only they are decoded.  False decodes the
    # whole grid (Detect(decode=True)) and runs nms_batched on it, the
    # reference-shaped path.
    lazy_decode: bool = True


def _aspect_canvas(img: Tensor, canvas_hw: Tuple[int, int]) -> Tensor:
    """Place images (N, sh, sw, C) into canvases (N, ch, cw, C),
    aspect-preserving, centred, black pad (static-shape ResizeImg)."""
    ch, cw = canvas_hw
    sh, sw = int(img.shape[1]), int(img.shape[2])
    scale = min(ch / sh, cw / sw)
    nh, nw = int(round(sh * scale)), int(round(sw * scale))
    resized = im.resize_bilinear(img, (nh, nw))
    canvas = img.new_zeros((img.shape[0], ch, cw, img.shape[-1]))
    t, l = (ch - nh) // 2, (cw - nw) // 2
    canvas[:, t:t + nh, l:l + nw] = resized
    return canvas


def to_host(tree):
    """Copy a step output (dicts of tensors) to numpy."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if tree is None:
        return None
    if tree.dtype == torch.bfloat16:
        tree = tree.float()
    return tree.cpu().numpy()


def start_to_host(tree) -> Callable[[], Dict[str, Any]]:
    """Start copying a step output's device tensors to pinned host memory
    on the current stream, without waiting; returns the function that
    waits for those copies and gives what :func:`to_host` gives.  Issued
    right after a step, the copies run before any later step on the
    stream, so a caller that launches the next step first (the server's
    one-deep pipeline) still gets this step's outputs as soon as it ends.
    The returned arrays own their memory, so the pinned blocks go back to
    PyTorch's host allocator and the next batch reuses them: allocating
    new pinned memory would wait for the card to finish its work.  The
    function's ``wait()`` waits for the copies alone (the serving layer
    times the wait and the conversion apart)."""
    on_card = []

    def start(t):
        if isinstance(t, dict):
            return {k: start(v) for k, v in t.items()}
        if t is None or t.device.type != "cuda":
            return t
        on_card.append(t)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def own(a):
        if isinstance(a, dict):
            return {k: own(v) for k, v in a.items()}
        return None if a is None else np.array(a)

    copies = start(tree)
    done = None
    if on_card:
        done = torch.cuda.Event()
        done.record()

    def wait():
        if done is not None:
            done.synchronize()

    def finish():
        wait()
        return own(to_host(copies)) if on_card else to_host(copies)

    finish.wait = wait
    return finish


class PlateRecognizer:
    """Batched detect -> enhance -> recognize.

    Construct with the loaded models; call :meth:`recognize` with a uint8
    frame batch.  The models are moved to ``device`` and cast to
    ``cfg.dtype`` in place."""

    def __new__(cls, *args, mesh=None, **kwargs):
        """A :class:`ShardedRecognizer` over ``mesh`` where one is given
        (the module docstring), else a plain recognizer."""
        if mesh is not None:
            return ShardedRecognizer(*args, mesh=mesh, **kwargs)
        return super().__new__(cls)

    def __init__(self, plate_model: YoloModel, char_model: YoloModel,
                 lpsr_model: LPSR, cfg: PipelineConfig = PipelineConfig(),
                 plate_class_ids: Sequence[int] = PLATE_CLASS_IDS,
                 char_names: Optional[Sequence[str]] = None,
                 device: DeviceLike = "cuda", mesh=None):
        """``mesh`` is taken by :meth:`__new__`, which then returns a
        :class:`ShardedRecognizer`."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.char_names = char_names
        self.plate_class_ids = tuple(int(i) for i in plate_class_ids)
        # fp32 convolutions and products in full fp32 (cuDNN's TF32 default
        # would change them); bf16 is unaffected.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if cfg.fused_front:
            from lpr_tpu_torch.kernels.yolo_front import front_geom

            front_geom(*cfg.det_hw)
            if self.device.type == "cuda" and cfg.dtype != torch.bfloat16:
                raise ValueError("fused_front runs the bf16 K1 kernel on a "
                                 "card: use dtype=torch.bfloat16 or "
                                 "fused_front=False")
        if cfg.fused_mid and not cfg.fused_front:
            raise ValueError("fused_mid runs on the fused front's output: "
                             "set fused_front as well")
        if cfg.packed_input and not cfg.fused_front:
            raise ValueError("packed_input feeds the fused front's uint8 "
                             "input: set fused_front as well")
        self._graphs: Dict[Tuple[int, ...], _Graph] = {}
        # CUDA graphs captured (one a batch shape, again after
        # replace_models); the card clock's offset to perf_counter_ns and
        # its uncertainty (ns), found at the last capture or at the first
        # eager step; the last step's phases and stamps
        self.graph_captures = 0
        self.clock_offset_ns = self.clock_uncertainty_ns = 0
        self._clock_known = False
        self.last_step: Optional[StepTrace] = None
        self.replace_models(plate_model, char_model, lpsr_model)

    def replace_models(self, plate_model: Optional[YoloModel] = None,
                       char_model: Optional[YoloModel] = None,
                       lpsr_model: Optional[LPSR] = None) -> None:
        """Swap in new models (None keeps the current one): they are moved
        to the device and cast to ``cfg.dtype`` in place, K1, K3 and K2 are
        packed anew, and the captured graphs, which hold the old packs, are
        dropped (the counterpart of the JAX recognizer's ``params`` setter,
        which rebuilds the frozen program)."""
        cfg = self.cfg
        if plate_model is not None:
            if cfg.int8_detector:
                # from the float32 weights as loaded, before the cast; the
                # K1/K3 packs below read the float weights the layers keep
                from lpr_tpu_torch.models.yolo import quantize_yolo

                quantize_yolo(plate_model)
            self.plate_model = plate_model.to(self.device, cfg.dtype).eval()
        if char_model is not None:
            self.char_model = char_model.to(self.device, cfg.dtype).eval()
        if lpsr_model is not None:
            self.lpsr_model = lpsr_model.to(self.device, cfg.dtype).eval()
        self._graphs.clear()
        self._front = None
        if cfg.fused_front:
            from lpr_tpu_torch.kernels.yolo_front import front_pack

            self._front = front_pack(
                self.plate_model,
                input_scale=1.0 / 255.0 if cfg.packed_input else 1.0)
        self._mid = None
        if cfg.fused_mid:
            from lpr_tpu_torch.kernels.yolo_mid import mid_pack

            self._mid = mid_pack(self.plate_model)
        # K2 on a card, its plain version on the CPU (kernels/lpsr.py), for
        # the configuration K2 takes; any other one runs LPSR.forward.
        self._lpsr = (lpsr_pack(self.lpsr_model)
                      if lpsr_kernel_takes(self.lpsr_model.cfg) else None)

    # ------------------------------------------------------------------
    def _per_plate(self, x: Tensor, boxes: Tensor):
        """Device-side geometry for every plate (B, P) of frames x: G1
        (:func:`plate_crops`; its plain version on the CPU), or without
        ``fast_geometry`` the gather-based sampler."""
        cfg = self.cfg
        shapes = dict(sr_hw=cfg.sr_hw, ocr_hw=cfg.ocr_hw,
                      long_aspect=cfg.long_aspect, deskew=cfg.deskew)
        if cfg.fast_geometry:
            crops = plate_crops(x, boxes, tile_hw=cfg.tile_hw, **shapes)
        else:
            def crop(angle, out_hw, **kw):
                return im.crop_rotated(x, boxes, angle, out_hw, **kw)

            crops = compose_crops(crop, boxes, **shapes)
        long_img, ocr_orig, is_long, _ = crops
        return long_img, ocr_orig, is_long

    def _sr_to_ocr_canvas(self, sr: Tensor, is_long: Tensor) -> Tensor:
        """SR outputs (N, sh, sw, 1) -> (N, ocr_h, ocr_w, 3) canvases."""
        sw = self.cfg.sr_hw[1]
        rgb = sr.expand(-1, -1, -1, 3)
        restacked = torch.cat([rgb[:, :, :sw // 2], rgb[:, :, sw // 2:]], 1)
        canv_sq = _aspect_canvas(restacked, self.cfg.ocr_hw)
        canv_long = _aspect_canvas(rgb, self.cfg.ocr_hw)
        return torch.where(is_long[:, None, None, None], canv_long, canv_sq)

    def host_letterbox(self, frames, out=None) -> Optional[np.ndarray]:
        """With ``packed_input``: the frames (numpy or tensor) letterboxed
        on the host into K1's uint8 input (:func:`im.letterbox_host`, the
        JAX step_raw's host pack), written into ``out`` where given (a host
        buffer of the result's shape); None otherwise."""
        if not self.cfg.packed_input:
            return None
        if isinstance(frames, torch.Tensor):
            frames = frames.cpu().numpy()
        return im.letterbox_host(frames, self.cfg.det_hw, out=out)

    def _upload(self, frames) -> Tensor:
        """uint8 frames (numpy, tensor or a sequence of frames) on the
        device."""
        if isinstance(frames, (list, tuple)):
            frames = np.stack(frames)
        if isinstance(frames, np.ndarray):   # torch needs a writable array
            frames = torch.from_numpy(np.require(frames, requirements="W"))
        return frames.to(self.device)

    def _upload_inputs(self, frames, packed=None):
        """The frames and, with ``packed_input``, the letterboxed frames on
        the device."""
        return (self._upload(frames),
                None if packed is None else self._upload(packed))

    def _letterbox(self, frames: Tensor, packed: Optional[Tensor] = None):
        """(frames in cfg.dtype / 255, detector input, gain, pad).  The
        detector input is the letterboxed frames in cfg.dtype, or with
        ``packed_input`` the host-letterboxed uint8 ones as they came, and
        gain and pad come from the letterbox geometry alone."""
        x = frames.to(self.cfg.dtype) / 255.0
        if packed is not None:
            fh, fw = int(frames.shape[1]), int(frames.shape[2])
            gain, _, (pad_l, pad_t) = im.letterbox_geom(fh, fw,
                                                        self.cfg.det_hw)
            return x, packed, float(gain), im.letterbox_pad(pad_l, pad_t,
                                                            x.device)
        lb, gain, pad = im.letterbox(x, self.cfg.det_hw, fill=0.0)
        return x, lb.contiguous(), gain, pad

    def _detect(self, lb: Tensor):
        """The raw Detect logits, or with ``lazy_decode=False`` (decoded
        predictions, raws)."""
        decode = not self.cfg.lazy_decode
        if lb.dtype == torch.uint8:
            return self.plate_model(None, front=self._front, mid=self._mid,
                                    packed=lb, decode=decode)
        return self.plate_model(lb, front=self._front, mid=self._mid,
                                decode=decode)

    def _plate_nms(self, out) -> Dict[str, Tensor]:
        kw = dict(max_det=16, pre_topk=64, multi_label=True, agnostic=True,
                  class_ids=self.plate_class_ids)
        if not self.cfg.lazy_decode:
            return nms_batched(out[0], self.cfg.det_conf, self.cfg.iou, **kw)
        return nms_from_raw(out, self.plate_model.strides,
                            self.plate_model.anchors, self.cfg.det_conf,
                            self.cfg.iou, **kw)

    def _top_plates(self, det: Dict[str, Tensor], gain: Tensor, pad: Tensor,
                    fh: int, fw: int):
        """The top ``max_plates`` detections by area, boxes in frame
        pixels: (boxes, scores, classes, areas)."""
        P = self.cfg.max_plates
        boxes = clip_boxes((det["boxes"] - torch.cat([pad, pad])) / gain,
                           fh, fw)
        areas = ((boxes[..., 2] - boxes[..., 0])
                 * (boxes[..., 3] - boxes[..., 1]))
        areas = torch.where(det["valid"], areas, -1.0)
        # lax.top_k order: descending, ties to the lower index
        top_areas, top_idx = torch.sort(areas, dim=1, descending=True,
                                        stable=True)
        top_areas, top_idx = top_areas[:, :P], top_idx[:, :P]
        sel_boxes = torch.gather(boxes, 1,
                                 top_idx[..., None].expand(-1, -1, 4))
        return (sel_boxes, torch.gather(det["scores"], 1, top_idx),
                torch.gather(det["classes"], 1, top_idx), top_areas)

    def _enhance(self, long_img: Tensor) -> Tensor:
        """LPSR on the (B, P, sh, sw, 3) crops -> (B*P, sh, sw, 1) float32."""
        sh, sw = self.cfg.sr_hw
        sr_in = (long_img.reshape(-1, sh, sw, 3).to(self.cfg.dtype)
                 .contiguous())
        if self._lpsr is not None:
            return lpsr_fused(sr_in, self._lpsr)
        return self.lpsr_model(sr_in).float()

    def _ocr_input(self, sr_out: Tensor, ocr_orig: Tensor,
                   is_long: Tensor) -> Tensor:
        """The char OCR batch: the raw crops (with ``ocr_on_original``)
        then the SR canvases, in cfg.dtype."""
        oh, ow = self.cfg.ocr_hw
        ocr_sr = self._sr_to_ocr_canvas(sr_out, is_long.reshape(-1))
        if self.cfg.ocr_on_original:
            ocr_in = torch.cat([ocr_orig.reshape(-1, oh, ow, 3).float(),
                                ocr_sr], 0)
        else:
            ocr_in = ocr_sr
        return ocr_in.to(self.cfg.dtype).contiguous()

    def _char_ocr(self, ocr_in: Tensor):
        """The char model's raw logits, or with ``lazy_decode=False``
        (decoded predictions, raws)."""
        return self.char_model(ocr_in, decode=not self.cfg.lazy_decode)

    def _char_nms(self, cout) -> Dict[str, Tensor]:
        cfg = self.cfg
        kw = dict(max_det=cfg.max_chars, pre_topk=cfg.char_pre_topk,
                  multi_label=True, agnostic=True)
        if not cfg.lazy_decode:
            return nms_batched(cout[0], cfg.ocr_conf, cfg.iou, **kw)
        return nms_from_raw(cout, self.char_model.strides,
                            self.char_model.anchors, cfg.ocr_conf, cfg.iou,
                            **kw)

    @torch.inference_mode()
    def step_raw(self, frames, packed=None, run=None) -> Dict[str, Any]:
        """The step: uint8 frames (B, H, W, 3) (numpy or tensor, or a
        sequence of B (H, W, 3) frames) -> dict of fixed-shape device tensors (``lpr_tpu``'s ``step_raw`` and
        ``_step_impl``).  With ``packed_input``, ``packed`` is the frames
        letterboxed by :meth:`host_letterbox`, which runs here when it is
        None.

        The step is the stages of :data:`STEP_STAGES`, in that order.  With
        ``run``, each stage is called as ``run(name, fn, *args)``, which
        must return ``fn(*args)``: how
        ``lpr_tpu_torch/tools/profile_stages.py`` measures each stage on
        the input the step gave it; the step then runs eagerly.  Without
        it, on a card with ``freeze_params``, the device step is one CUDA
        graph replay (:meth:`_frozen_step`), and the outputs are copies
        that the next step does not overwrite."""
        if packed is not None and not self.cfg.packed_input:
            raise ValueError("letterboxed frames go to K1's uint8 input: set "
                             "PipelineConfig(packed_input=True)")
        if run is None and self.cfg.freeze_params and \
                self.device.type == "cuda":
            return self._frozen_step(frames, packed)
        return self.step_eager(frames, packed, run)

    @torch.inference_mode()
    def step_eager(self, frames, packed=None, run=None) -> Dict[str, Any]:
        """:meth:`step_raw` with every stage launched from the host, as
        ``freeze_params=False`` runs it."""
        run = run or _call
        t0 = time.perf_counter_ns()
        if packed is None:
            packed = run("host letterbox", self.host_letterbox, frames)
        x, pk = run("upload", self._upload_inputs, frames, packed)
        t1 = time.perf_counter_ns()
        if not self._clock_known:
            self._calibrate()
        stamps = self._stamps()
        out = self._device_step(x, pk, _Stamper(stamps, run))
        self.last_step = StepTrace(
            (("staging", t0, t1), ("replay", t1, time.perf_counter_ns())),
            stamps)
        return out

    def _calibrate(self) -> None:
        """:func:`calibrate` the device's clock against the host's."""
        self.clock_offset_ns, self.clock_uncertainty_ns = calibrate(
            self.device)
        self._clock_known = True

    def _stamps(self) -> Tensor:
        """A stamps row on the device (:class:`StepTrace`): column 0 the
        clock's offset, the rest for the step's stamps (a fill, so no
        copy from the host waits for the step in flight)."""
        return torch.full((1, 1 + N_STAMPS), self.clock_offset_ns,
                          dtype=torch.int64, device=self.device)

    def _device_step(self, x: Tensor, pk: Optional[Tensor],
                     run: Callable = _call) -> Dict[str, Any]:
        """The device stages, "letterbox+norm" to "char NMS", on the
        uploaded frames (and letterboxed frames): what a graph captures."""
        cfg = self.cfg
        B, fh, fw = int(x.shape[0]), int(x.shape[1]), int(x.shape[2])
        P = cfg.max_plates
        x, lb, gain, pad = run("letterbox+norm", self._letterbox, x, pk)
        raws = run("plate detector", self._detect, lb)
        det = run("plate NMS", self._plate_nms, raws)
        sel_boxes, sel_scores, sel_classes, top_areas = run(
            "top plates", self._top_plates, det, gain, pad, fh, fw)
        long_img, ocr_orig, is_long = run(
            "crop/deskew geometry", self._per_plate, x, sel_boxes)
        sr_out = run("LPSR", self._enhance, long_img)
        ocr_in = run("OCR canvases", self._ocr_input, sr_out, ocr_orig,
                     is_long)
        cout = run("char OCR", self._char_ocr, ocr_in)
        cdet = run("char NMS", self._char_nms, cout)
        sh, sw = cfg.sr_hw
        n_orig = B * P if cfg.ocr_on_original else 0

        def split(lo, hi):
            return {k: v[lo:hi].reshape(B, P, *v.shape[1:])
                    for k, v in cdet.items()}

        return {
            "plate_boxes": sel_boxes,
            "plate_scores": sel_scores,
            "plate_classes": sel_classes,
            "plate_valid": top_areas > 0,
            "is_long": is_long,
            "sr": sr_out.reshape(B, P, sh, sw, 1),
            "chars_orig": split(0, n_orig) if cfg.ocr_on_original else None,
            "chars_sr": split(n_orig, n_orig + B * P),
        }

    def _load_inputs(self, fr: _Staged, pk: Optional[_Staged], frames,
                     packed) -> None:
        """The step's inputs into the graph's static buffers.  With
        ``packed_input`` and no ``packed``, the host letterbox writes
        straight into the pinned buffer (:meth:`_Staged.fill`), which is
        then copied in: no intermediate array."""
        fr.load(frames)
        if pk is None:
            return
        if packed is not None:
            pk.load(packed)
        elif isinstance(frames, torch.Tensor) and frames.device.type == "cuda":
            pk.load(self.host_letterbox(frames))
        else:
            pk.fill(lambda host: self.host_letterbox(frames, out=host))

    def _frozen_step(self, frames, packed) -> Dict[str, Any]:
        """The device step as a replay of the graph captured for this frame
        shape (captured here at its first call): the inputs go into the
        graph's static buffers, the graph replays on the current stream,
        the kernels it holds are added to their launch counts, and the
        outputs are copied out of the graph's pool."""
        t0 = time.perf_counter_ns()
        key = _batch_shape(frames)
        g = self._graphs.get(key)
        first = "staging"
        if g is None:
            g = self._graphs[key] = self._capture(frames, packed)
            self.graph_captures += 1
            first = "capture"
        else:
            self._load_inputs(g.frames, g.packed, frames, packed)
        t1 = time.perf_counter_ns()
        g.graph.replay()
        _add_counts(g.launches)
        t2 = time.perf_counter_ns()
        out = _clone(g.out)
        stamps = g.stamps.clone()
        self.last_step = StepTrace(
            ((first, t0, t1), ("replay", t1, t2),
             ("clone", t2, time.perf_counter_ns())), stamps)
        return out

    def _capture(self, frames, packed) -> _Graph:
        """Capture the device step for ``frames``' shape: static input
        buffers loaded with these inputs, :data:`GRAPH_WARMUP` eager runs
        on a side stream, then one run captured with ``torch.cuda.graph``.
        The kernels' launch counts move only at capture; the counts the
        graph holds are recorded for its replays and the capture's own
        are taken back.  Any failure raises.  The capture runs on a side
        stream of this recognizer's device (``torch.cuda.graph``'s own
        default is one stream made on whichever card was current at its
        first use).  The kernels' launchers go to the capturing stream
        (``torch.cuda.current_stream()``), and what
        they call at every launch, ``cudaFuncSetAttribute`` and K2's
        cluster launch, captures (checked on an H100).  Before the capture
        the card's clock is calibrated against the host's
        (:func:`calibrate`), and the graph stamps each stage boundary into
        its stamps buffer (:class:`_Stamper`)."""
        dev = self.device
        shape = _batch_shape(frames)
        fr = _Staged(shape, dev)
        pk = None
        if self.cfg.packed_input:
            pk = _Staged((shape[0], *self.cfg.det_hw, 3), dev)
        self._load_inputs(fr, pk, frames, packed)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                self._device_step(fr.device, None if pk is None
                                  else pk.device)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._calibrate()
        stamps = self._stamps()
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self._device_step(fr.device, None if pk is None
                                        else pk.device, _Stamper(stamps))
        finally:
            held = tuple(a - b for a, b in zip(_counts(), before))
            _add_counts(tuple(-n for n in held))
        return _Graph(graph, fr, pk, out, held, stamps)

    def recognize(self, frames) -> List[List[Dict[str, Any]]]:
        """frames: (B, H, W, 3) uint8 RGB.  Per-frame lists of plate dicts
        with the original-crop and SR strings."""
        return self.assemble(to_host(self.step_raw(frames)))

    def assemble(self, out: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        """Host post-processing of a fetched (:func:`to_host`) step output."""
        results: List[List[Dict[str, Any]]] = []
        kw = {} if self.char_names is None else {"names": self.char_names}
        co, cs = out["chars_orig"], out["chars_sr"]
        B, P = out["plate_valid"].shape
        for b in range(B):
            plates = []
            for p in range(P):
                if not out["plate_valid"][b, p]:
                    continue
                plates.append({
                    "box": out["plate_boxes"][b, p].tolist(),
                    "score": float(out["plate_scores"][b, p]),
                    "class_id": int(out["plate_classes"][b, p]),
                    "is_long": bool(out["is_long"][b, p]),
                    "text": detections_to_string(
                        co["boxes"][b, p], co["classes"][b, p],
                        co["valid"][b, p], **kw) if co is not None else "",
                    "text_sr": detections_to_string(
                        cs["boxes"][b, p], cs["classes"][b, p],
                        cs["valid"][b, p], **kw),
                    "sr": out["sr"][b, p] if "sr" in out else None,
                })
            results.append(plates)
        return results


def _on(device: torch.device):
    """``device`` as the current card, for a card; nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedRecognizer:
    """:class:`PlateRecognizer` over a mesh (the module docstring), as
    ``PlateRecognizer(..., mesh=)`` builds it: ``replicas`` holds one plain
    recognizer a mesh device, the first with the models passed in and the
    others with deep copies; ``device`` (the constructor's is not used) is
    the first mesh device, where the outputs are gathered."""

    def __init__(self, plate_model: YoloModel, char_model: YoloModel,
                 lpsr_model: LPSR, cfg: PipelineConfig = PipelineConfig(),
                 plate_class_ids: Sequence[int] = PLATE_CLASS_IDS,
                 char_names: Optional[Sequence[str]] = None,
                 device: DeviceLike = None, mesh=None):
        self.mesh = mesh
        self.cfg = cfg
        self.char_names = char_names
        models = _copies((plate_model, char_model, lpsr_model),
                         len(mesh.devices))
        self.replicas = [
            PlateRecognizer(*m, cfg=cfg, plate_class_ids=plate_class_ids,
                            char_names=char_names, device=d)
            for m, d in zip(models, mesh.devices)]
        self.device = self.replicas[0].device
        self.last_step: Optional[StepTrace] = None

    @property
    def graph_captures(self) -> int:
        return sum(r.graph_captures for r in self.replicas)

    def replace_models(self, plate_model: Optional[YoloModel] = None,
                       char_model: Optional[YoloModel] = None,
                       lpsr_model: Optional[LPSR] = None) -> None:
        """:meth:`PlateRecognizer.replace_models` on every replica, each
        with a copy."""
        models = _copies((plate_model, char_model, lpsr_model),
                         len(self.replicas))
        for rep, m in zip(self.replicas, models):
            rep.replace_models(*m)

    def step_raw(self, frames, packed=None, run=None) -> Dict[str, Any]:
        """:meth:`PlateRecognizer.step_raw` of each replica on its share."""
        return self._sharded("step_raw", frames, packed, run)

    def step_eager(self, frames, packed=None, run=None) -> Dict[str, Any]:
        """:meth:`PlateRecognizer.step_eager` of each replica on its
        share."""
        return self._sharded("step_eager", frames, packed, run)

    def _sharded(self, method: str, frames, packed, run) -> Dict[str, Any]:
        """``method`` of each replica on its share of the batch, issued in
        turn with the replica's card current; the outputs concatenated on
        the first device."""
        from lpr_tpu_torch.parallel.mesh import split_batch

        n = len(self.replicas)
        shares = zip(split_batch(frames, n), [None] * n if packed is None
                     else split_batch(packed, n))
        outs = []
        for rep, (f, p) in zip(self.replicas, shares):
            with _on(rep.device):
                outs.append(getattr(rep, method)(f, p, run))
        traces = [rep.last_step for rep in self.replicas]
        dev = traces[0].stamps.device
        self.last_step = StepTrace(
            tuple(ph for t in traces for ph in t.phases),
            torch.cat([t.stamps.to(dev) for t in traces]))
        return _concat(outs, self.device)

    def host_letterbox(self, frames, out=None) -> Optional[np.ndarray]:
        return self.replicas[0].host_letterbox(frames, out)

    def recognize(self, frames) -> List[List[Dict[str, Any]]]:
        return self.assemble(to_host(self.step_raw(frames)))

    def assemble(self, out: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        return self.replicas[0].assemble(out)


def _copies(models: Tuple[Any, ...], n: int) -> List[Tuple[Any, ...]]:
    """``models`` for the first replica and deep copies for the other
    ``n - 1`` (before any replica moves or casts them in place)."""
    return [models] + [copy.deepcopy(models) for _ in range(n - 1)]
