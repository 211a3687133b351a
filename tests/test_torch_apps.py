"""The apps on the CPU: annotation and panels against the JAX package's
(byte for byte outside the text, whose font differs by design), and the
run / sr / serve / evaluate / find_improvement CLIs with ``--device cpu``,
against the port's own entry points and, where it is cheap, the JAX
CLIs; their refusals, and their default to the card."""

import builtins
import io
import json
import os
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from lpr_tpu.cli import find_improvement as jfi
from lpr_tpu.cli import sr as jsr
from lpr_tpu.pipeline import annotate as jannotate
from lpr_tpu_torch import imageio, native
from lpr_tpu_torch.cli import evaluate as cli_evaluate
from lpr_tpu_torch.cli import find_improvement as cli_fi
from lpr_tpu_torch.cli import run as cli_run
from lpr_tpu_torch.cli import serve as cli_serve
from lpr_tpu_torch.cli import sr as cli_sr
from lpr_tpu_torch.eval.harness import EvalReport, OcrEvaluator
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as tyolo
from lpr_tpu_torch.pipeline import annotate as tannotate
from lpr_tpu_torch.pipeline import draw

from .torch_ref import CHAR, LPSR, PLATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
CPU = ["--device", "cpu"]
WEIGHTS = ["--r-weights", CHAR, "--sr-weights", LPSR]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread: the suite runs several test
    processes at once, and there PyTorch's thread pool, waiting for busy
    cores, made these tests up to 25x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- annotation ----------------------------------------------------------

def _frame(hw, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (*hw, 3), dtype=np.uint8)


def _plates(hw):
    """Three plates with boxes apart from each other and from the FPS
    counter, strings, scores and SR crops."""
    h, w = hw
    rng = np.random.RandomState(1)
    out = []
    for i, (text, sr_text) in enumerate([("15A37254", "15A37264"),
                                         ("", "51G18593"), ("A0E34", "")]):
        x1, y1 = int(w * (0.1 + 0.3 * i)), int(h * (0.35 + 0.2 * (i % 2)))
        out.append({"box": [x1 + 0.7, y1 + 0.2, x1 + w * 0.15,
                            y1 + h * 0.06],
                    "text": text, "text_sr": sr_text,
                    "score": 0.5 + 0.1 * i,
                    "sr": rng.rand(32, 192, 1).astype(np.float32)})
    return out


def _pil_box(xy, text, size, shape):
    d = ImageDraw.Draw(Image.new("RGB", (shape[1], shape[0])))
    return d.textbbox(xy, text, font=jannotate._font(size))


def _mask(shape, boxes):
    m = np.zeros(shape[:2], bool)
    for x0, y0, x1, y1 in boxes:
        m[max(int(y0), 0):max(int(y1), 0), max(int(x0), 0):max(int(x1), 0)] \
            = True
    return m


def _check_text(got, base, labels):
    """Inside each of the port's text boxes the pixels the text changed
    have the label's colour, and some did change."""
    for xy, text, size, color in labels:
        x0, y0, x1, y1 = draw.text_box(xy, text, size)
        y0, x0 = max(y0, 0), max(x0, 0)
        g, b = got[y0:y1, x0:x1], base[y0:y1, x0:x1]
        changed = (g != b).any(-1)
        assert changed.any(), text
        assert (g[changed] == color).all(), text


@pytest.mark.parametrize("hw", [(360, 640), (720, 1280)])
def test_annotate_frame_matches_jax_outside_the_text(hw):
    frame, plates = _frame(hw), _plates(hw)
    got = tannotate.annotate_frame(frame, plates, fps=23.456)
    ref = jannotate.annotate_frame(frame, plates, fps=23.456)
    assert got.dtype == np.uint8 and got.shape == frame.shape
    labels = tannotate.frame_labels(hw, plates, 23.456)
    assert len(labels) == 7
    boxes = [draw.text_box(*lab[:3]) for lab in labels] + [
        _pil_box(xy, text, size, hw) for xy, text, size, _ in labels]
    outside = ~_mask(hw, boxes)
    np.testing.assert_array_equal(got[outside], ref[outside])
    rects = frame.copy()
    for i, p in enumerate(plates):
        draw.draw_rect(rects, p["box"], tannotate.COLORS[i],
                       max(2, hw[0] // 360))
    _check_text(got, rects, labels)
    np.testing.assert_array_equal(frame, _frame(hw))     # not drawn on


def _panel_labels(plates, slot_w):
    out = []
    for i, p in enumerate(plates[:3]):
        x0, y = i * slot_w + 10, 10
        out.append(((x0, y), f"Plate #{i+1} conf {p.get('score', 0):.2f}",
                    16, tannotate.PANEL_TITLE))
        y += 24 + (48 if p.get("sr") is not None else 0)
        out.append(((x0, y), f"OCR:    {p.get('text','')}", 16,
                    tannotate.PANEL_OCR))
        out.append(((x0, y + 22), f"SR OCR: {p.get('text_sr','')}", 16,
                    tannotate.COLORS[i]))
    return out


@pytest.mark.parametrize("n", [1, 3])
def test_side_panel_matches_jax_outside_the_text(n):
    """The SR crops pasted with Pillow's bicubic resample, the background
    and the layout equal the JAX panel's byte for byte outside the text."""
    plates = _plates((720, 1280))[:n]
    plates[-1]["sr"] = None if n == 3 else plates[-1]["sr"]
    got, ref = tannotate.side_panel(plates), jannotate.side_panel(plates)
    assert got.shape == ref.shape == (300, 900, 3)
    labels = _panel_labels(plates, 900 // n)
    boxes = [draw.text_box(*lab[:3]) for lab in labels] + [
        _pil_box(xy, text, size, got.shape) for xy, text, size, _ in labels]
    outside = ~_mask(got.shape, boxes)
    np.testing.assert_array_equal(got[outside], ref[outside])
    _check_text(got, np.full_like(got, 30), labels)


def test_render_panel_matches_jax_outside_the_text():
    lr = _frame((43, 389), seed=4)
    sr = _frame((32, 192), seed=5)
    args = ("15A37254", "15A3725", 0.31, "15A37254", 0.93)
    got, ref = cli_fi.render_panel(lr, sr, *args), jfi.render_panel(lr, sr,
                                                                    *args)
    assert got.shape == ref.shape == (260, 420, 3)
    labels = [((10, 8), "Ground Truth: 15A37254", 16, cli_fi.GT_COLOR),
              ((10, 96), "OCR: 15A3725 (conf 0.31)", 16, cli_fi.BAD_COLOR),
              ((10, 186), "SR OCR: 15A37254 (conf 0.93)", 16,
               cli_fi.OK_COLOR)]
    jfont = jannotate._font(16)
    d = ImageDraw.Draw(Image.new("RGB", (420, 260)))
    boxes = [draw.text_box(*lab[:3]) for lab in labels] + [
        d.textbbox(xy, t, font=jfont) for xy, t, _, _ in labels]
    outside = ~_mask(got.shape, boxes)
    np.testing.assert_array_equal(got[outside], ref[outside])
    _check_text(got, np.full_like(got, 40), labels)


# ---- the CLIs ------------------------------------------------------------

@pytest.fixture(scope="module")
def port_ev():
    """The port's evaluator on the CPU with the repo's checkpoints."""
    char, _, ck = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    names = ck.names
    return OcrEvaluator(char, tlpsr.load_lpsr(LPSR, device="cpu"),
                        names=names, device="cpu")


def test_cli_evaluate_json_equals_the_evaluator(tmp_path, port_ev):
    folder = os.path.join(FIX, "real_plates2")
    out = str(tmp_path / "eval.json")
    rep = cli_evaluate.main(["--eval-folder", folder, "--sr-weights", LPSR,
                             "--ocr-weights", CHAR, "--batch", "8",
                             "--per-image", "--json-out", out, *CPU])
    with open(out) as f:
        got = json.load(f)
    want = port_ev.evaluate_folder(folder, batch_size=8)
    assert got == json.loads(json.dumps(
        cli_evaluate.report_json(want, True)))
    assert rep.per_image == want.per_image
    assert set(got["per_image"][0]) == {"gt", "raw", "sr", "raw_conf",
                                        "sr_conf", "index"}


def test_cli_sr_matches_the_evaluator_path(tmp_path, port_ev):
    """cli/sr on the LR strips: each PNG (32, 192, 3) equals, within 1 LSB,
    the evaluator's SR input (Pillow bicubic) through K2's plain version,
    truncated to uint8 as the JAX cli/sr does."""
    src = os.path.join(FIX, "real_lr_strips")
    names = cli_sr.main(["--weights", LPSR, "--input-dir", src,
                         "--output-dir", str(tmp_path / "port"), *CPU])
    assert names == imageio.list_images(src)
    ev = port_ev
    for name in names:
        got = imageio.read_rgb(str(tmp_path / "port" / name))
        assert got.shape == (32, 192, 3)
        _, sr_in = ev._prep_host(imageio.read_rgb(os.path.join(src, name)))
        with torch.inference_mode():
            sr = ev._enhance(torch.from_numpy(sr_in[None])).numpy()[0]
        want = (np.clip(np.repeat(sr, 3, -1), 0, 1) * 255).astype(np.uint8)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_cli_sr_cyclegan_pth_matches_the_jax_cli(tmp_path):
    """--model cyclegan with a .pth (the repo's CycleGAN weights saved as
    the reference Generator's state dict): the port's PNGs equal the JAX
    cli/sr's within 1 LSB."""
    from lpr_tpu_torch.weights.checkpoint import load_state

    state, _ = load_state("checkpoints/cyclegan_real_g.npz")
    sd = {}

    def put(name, key):
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            state[f"{key}/w"].transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(state[f"{key}/b"])

    for key, i in (("head", 1), ("down0", 4), ("down1", 7), ("up0", 20),
                   ("up1", 23), ("tail", 26)):
        put(f"model.{i}", key)
    for j, i in enumerate(range(10, 19)):
        put(f"model.{i}.conv_block.1", f"blocks/{j}/c0")
        put(f"model.{i}.conv_block.5", f"blocks/{j}/c1")
    pth = str(tmp_path / "G_real.pth")
    torch.save(sd, pth)
    src = os.path.join(FIX, "real_lr_strips")
    common = ["--weights", pth, "--model", "cyclegan", "--input-dir", src]
    names = cli_sr.main(common + ["--output-dir", str(tmp_path / "port"),
                                  *CPU])
    jsr.main(common + ["--output-dir", str(tmp_path / "jax")])
    for name in names:
        got = imageio.read_rgb(str(tmp_path / "port" / name))
        ref = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == ref.shape == (32, 192, 3)
        assert np.abs(got.astype(int) - ref).max() <= 1


def test_cli_sr_writes_png_for_a_jpeg_input(tmp_path, monkeypatch):
    """A .jpg input is written as <name>.jpg.png; where host_decode does
    not build, a JPEG input raises with the build's message."""
    src = tmp_path / "in"
    src.mkdir()
    buf = io.BytesIO()
    Image.fromarray(_frame((20, 60))).save(buf, "JPEG")
    (src / "a.jpg").write_bytes(buf.getvalue())
    imageio.write_png(str(src / "b.png"), _frame((20, 60), seed=2))
    names = cli_sr.main(["--weights", LPSR, "--input-dir", str(src),
                         "--output-dir", str(tmp_path / "out"), *CPU])
    assert names == ["a.jpg.png", "b.png"]
    assert sorted(os.listdir(tmp_path / "out")) == names
    for n in names:
        assert imageio.read_rgb(str(tmp_path / "out" / n)).shape == (32, 192,
                                                                     3)

    def no_library(name):
        raise RuntimeError(f"g++ failed building {name}: jpeglib.h: No "
                           f"such file or directory")

    monkeypatch.setattr(native, "library", no_library)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        cli_sr.main(["--weights", LPSR, "--input-dir", str(src),
                     "--output-dir", str(tmp_path / "out2"), *CPU])


def _run_argv(src, out, *more):
    return ["--source", str(src), "--d-weights", PLATE, *WEIGHTS, "--out",
            str(out), "--imgsz-det", "320", "--batch", "2", *CPU, *more]


def test_cli_run_prints_what_recognize_returns(tmp_path, capsys):
    """Two frames (a 256x512 cut of the demo frame around its plates and
    its mirror image) at --imgsz-det 320, --d-conf 0.4: the printed plates
    are recognize()'s, frames and panels are PNG."""
    demo = np.ascontiguousarray(imageio.read_rgb(os.path.join(
        FIX, "real_frames", "demo_frame.png"))[180:436, 368:880])
    frames = [demo, np.ascontiguousarray(demo[:, ::-1])]
    src = tmp_path / "src"
    src.mkdir()
    for i, f in enumerate(frames):
        imageio.write_png(str(src / f"f{i}.png"), f)
    argv = _run_argv(src, tmp_path / "out", "--panel", "--d-conf", "0.4")
    printed = cli_run.main(argv)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("frame ")]
    want = cli_run.build_recognizer(cli_run.parse_args(argv)).recognize(
        np.stack(frames))
    assert [[(p["text"], p["text_sr"]) for p in f] for f in printed] == [
        [(p["text"], p["text_sr"]) for p in f] for f in want]
    assert lines == [f"frame {i}: {p['text']!r} / SR {p['text_sr']!r} "
                     f"conf {p['score']:.2f}"
                     for i, f in enumerate(want) for p in f]
    assert sum(map(len, want)) >= 1
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == sorted(["frame_000000.png", "frame_000001.png"] + [
        f"panel_{i:06d}.png" for i, f in enumerate(want) if f])
    ann = imageio.read_rgb(str(tmp_path / "out" / "frame_000000.png"))
    assert ann.shape == demo.shape and (ann != demo).any()


def test_cli_run_step_pause(monkeypatch):
    """--step (reference inference/run.py:273-277): Enter advances, 'q'
    and EOF stop."""
    answers = iter(["", "  ", "Q quit now"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
    assert cli_run._step_pause(0) is True
    assert cli_run._step_pause(1) is True
    assert cli_run._step_pause(2) is False

    def eof(prompt=""):
        raise EOFError

    monkeypatch.setattr(builtins, "input", eof)
    assert cli_run._step_pause(3) is False
    assert cli_run.parse_args(
        ["--source", "x", "--r-weights", "r", "--sr-weights", "s", "--step"]
    ).step is True


def test_cli_run_step_early_stop(tmp_path, monkeypatch):
    """'q' at the first pause stops main() after one frame: later batches
    are neither recognized nor written."""
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        imageio.write_png(str(src / f"f{i}.png"),
                          np.zeros((32, 48, 3), np.uint8) + 40 * i)
    calls = []

    class StubRec:
        def recognize(self, batch):
            calls.append(len(batch))
            return [[] for _ in batch]

    monkeypatch.setattr(cli_run, "build_recognizer", lambda a: StubRec())
    monkeypatch.setattr(builtins, "input", lambda prompt="": "q")
    out = str(tmp_path / "out")
    cli_run.main(["--source", str(src), "--r-weights", "r",
                  "--sr-weights", "s", "--out", out, "--batch", "2",
                  "--step"])
    assert calls == [2]  # second batch never recognized
    assert sorted(os.listdir(out)) == ["frame_000000.png"]


@pytest.mark.parametrize("d_weights,err", [
    (None, ValueError), ("plate.pt", ValueError),
    ("checkpoints/plate_det640", ValueError)])
def test_cli_run_refuses_detector_weights_that_are_not_npz(d_weights, err):
    """The JAX build_recognizer keeps random weights for a .pt; the port
    raises for anything but the npz."""
    argv = ["--source", "x", *WEIGHTS, *CPU]
    if d_weights:
        argv += ["--d-weights", d_weights]
    with pytest.raises(err, match="npz"):
        cli_run.build_recognizer(cli_run.parse_args(argv))


@pytest.mark.parametrize("app", ["run", "evaluate"])
def test_cli_run_and_evaluate_load_a_char_pt(app, tmp_path):
    """cli/run's --r-weights and cli/evaluate's --ocr-weights take a char.pt
    (written by the test, tests/pt_fixture.py): the app's char model holds
    the weights of the JAX load_char_ocr of the same file (every buffer
    equal, in the app's dtype) and its class names."""
    from lpr_tpu.models import yolo as jyolo
    from lpr_tpu_torch.weights.checkpoint import params_from_jax

    from .test_torch_pt_import import CHAR_NAMES, _char_pt

    path = _char_pt(tmp_path)
    if app == "run":
        rec = cli_run.build_recognizer(cli_run.parse_args(
            ["--source", "x", "--d-weights", PLATE, "--r-weights", path,
             "--sr-weights", LPSR, *CPU]))
        model, names = rec.char_model, rec.char_names
    else:
        ev = cli_evaluate.build_evaluator(path, LPSR, "cpu")
        model, names = ev.char_model, ev.names
    jm, jp, jck = jyolo.load_char_ocr(path)
    assert names == jck.names == CHAR_NAMES
    want = tyolo.build_yolo(tyolo.char_ocr_spec(), ckpt_anchors=jm.anchors,
                            strides=(8,)).load_state(params_from_jax(jp))
    got = dict(model.named_buffers())
    dtype = next(iter(got.values())).dtype
    want = dict(want.to(dtype).named_buffers())
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cli_serve_starts_and_stops(monkeypatch, capsys):
    """main() starts the server and the HTTP front end on a free port,
    answers there, and on KeyboardInterrupt (here from the stats loop's
    sleep) stops both and returns."""
    from lpr_tpu_torch.serve import http, server

    stopped = []
    for cls in (http.HttpFrontend, server.InferenceServer):
        orig = cls.stop

        def stop(self, *a, _orig=orig, **kw):
            stopped.append(type(self).__name__)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, "stop", stop)
    urls = []

    def sleep(s):
        url = capsys.readouterr().out.split()[2]
        with urllib.request.urlopen(url + "/v2/health/ready",
                                    timeout=30) as r:
            assert r.read() == b"READY"
        urls.append(url)
        raise KeyboardInterrupt

    monkeypatch.setattr(cli_serve, "time", types.SimpleNamespace(sleep=sleep))
    assert cli_serve.main(["--d-weights", PLATE, *WEIGHTS, "--port", "0",
                           "--imgsz-det", "320", *CPU]) == 0
    assert sorted(stopped) == ["HttpFrontend", "InferenceServer"]
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(urls[0] + "/v2/health/ready", timeout=5)


class _StubEv:
    """The evaluator's surface that find_improvement uses, with a given
    report and a blank SR image."""

    def __init__(self, report):
        self.report = report
        self.params = None

    def evaluate_arrays(self, images, gts, batch_size=64):
        assert [r["gt"] for r in self.report.per_image] == list(gts)
        return self.report

    def _prep_host(self, img):
        return (np.zeros((128, 128, 3), np.float32),
                np.zeros((32, 192, 3), np.float32))

    def run_batch(self, canvases, sr_ins):
        return None, np.full((len(sr_ins), 32, 192, 1), 0.5, np.float32)

    def _batch_fn(self, params, canvas, sr_in):
        return None, np.full((1, 32, 192, 1), 0.5, np.float32)


def test_find_improvement_selects_what_the_jax_gates_select(tmp_path,
                                                            monkeypatch):
    from lpr_tpu.eval import harness as jharness
    from lpr_tpu.models import lpsr as jlpsr
    from lpr_tpu.models import yolo as jyolo

    rows = [  # raw_conf, sr correct, sr_conf
        (0.2, True, 0.9), (0.44, True, 0.7), (0.45, True, 0.9),
        (0.1, False, 0.95), (0.3, True, 0.69), (0.0, True, 1.0)]
    folder = tmp_path / "plates"
    folder.mkdir()
    per_image = []
    for i, (rc, ok, sc) in enumerate(rows):
        gt = f"P{i}AB"
        imageio.write_png(str(folder / f"{gt.lower()}.png"),
                          _frame((24, 90), seed=i))
        per_image.append({"gt": gt, "raw": "X", "sr": gt if ok else "Y",
                          "raw_conf": rc, "sr_conf": sc, "index": i})
    rep = EvalReport(len(rows), 0.0, 0.0, 1.0, 1.0, per_image)
    monkeypatch.setattr(jharness, "OcrEvaluator",
                        lambda *a, **kw: _StubEv(rep))
    monkeypatch.setattr(jlpsr, "load_lpsr", lambda path: None)
    monkeypatch.setattr(jyolo, "load_char_ocr", lambda path: (
        None, None, types.SimpleNamespace(names=None)))
    monkeypatch.setattr(cli_evaluate, "build_evaluator",
                        lambda *a, **kw: _StubEv(rep))
    argv = ["--eval-folder", str(folder), "--sr-weights", "s",
            "--ocr-weights", "o"]
    jfi.main(argv + ["--out", str(tmp_path / "jax")])
    found = cli_fi.main(argv + ["--out", str(tmp_path / "port"), *CPU])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == sorted(
        f"improved_{g}.png" for g in found)
    assert found == ["P0AB", "P1AB", "P5AB"]
    panel = imageio.read_rgb(str(tmp_path / "port" / "improved_P0AB.png"))
    assert panel.shape == (260, 420, 3)


def test_find_improvement_clahe_needs_cv2(monkeypatch):
    """--clahe runs cv2's CLAHE; without cv2 it raises (the JAX
    clahe_gray returns the image unchanged)."""
    img = _frame((24, 90))
    try:
        import cv2  # noqa: F401
    except ImportError:
        pass
    else:
        out = cli_fi.clahe_gray(img)
        assert out.shape == img.shape and (out[..., 0] == out[..., 2]).all()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        cli_fi.clahe_gray(img)


@pytest.mark.parametrize("cli,argv", [
    (cli_evaluate, ["--eval-folder", "x", "--sr-weights", LPSR,
                    "--ocr-weights", CHAR]),
    (cli_sr, ["--weights", LPSR, "--input-dir", "x", "--output-dir", "y"]),
    (cli_run, ["--source", "x", "--d-weights", PLATE, *WEIGHTS]),
    (cli_serve, ["--d-weights", PLATE, *WEIGHTS]),
    (cli_fi, ["--eval-folder", "x", "--sr-weights", LPSR, "--ocr-weights",
              CHAR]),
])
def test_clis_default_to_the_card(cli, argv, monkeypatch):
    """Without --device each CLI runs on the card, and raises without one;
    so does the evaluator without device=."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    char, _, _ = tyolo.load_char_ocr_npz(CHAR, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        OcrEvaluator(char, tlpsr.load_lpsr(LPSR, device="cpu"))
