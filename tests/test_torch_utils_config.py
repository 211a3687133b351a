"""The port's last modules against the JAX package's, on the CPU:
``utils/autobatch.py`` (``traced_bytes`` on ``tests/test_utils2.py``'s
functions: the same lower bounds and the same output bytes; ``autobatch``
a power of two, monotone in ``hbm_bytes``, and needing it off a card),
``utils/observability.py`` (``model_summary`` equal to JAX's,
``device_sync``, ``profile_trace`` writing a trace and raising where the JAX one swallows a
failure to stop), ``config.py`` (every ``REGISTRY`` kind round-trips, a
file written by either package loads in the other to equal fields, the
text equals ``yaml.safe_dump``'s, an unknown dtype raises), and the
coverage of the whole package: every ``.py`` of ``lpr_tpu/`` has its
counterpart in ``lpr_tpu_torch/``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lpr_tpu import config as jc
from lpr_tpu.utils.autobatch import traced_bytes as j_traced
from lpr_tpu_torch import config as tc
from lpr_tpu_torch.utils import observability as tobs
from lpr_tpu_torch.utils.autobatch import autobatch, traced_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX module -> the port's, where the names differ: the Pallas kernels
# are the CUDA kernels' wrappers, the native loader one module, the
# StableHLO export torch.export's program
MAPPED = {
    "ops/pallas/__init__.py": "kernels/__init__.py",
    "ops/pallas/lpsr_kernel.py": "kernels/lpsr.py",
    "ops/pallas/yolo_front.py": "kernels/yolo_front.py",
    "ops/pallas/yolo_mid.py": "kernels/yolo_mid.py",
    "native/__init__.py": "native.py",
    "weights/export_stablehlo.py": "weights/export_program.py",
}


def _modules(pkg):
    out = set()
    for dp, _, files in os.walk(os.path.join(ROOT, pkg)):
        out |= {os.path.relpath(os.path.join(dp, f), os.path.join(ROOT, pkg))
                for f in files if f.endswith(".py")}
    return out


def test_every_jax_module_has_its_counterpart():
    port = _modules("lpr_tpu_torch")
    missing = sorted(m for m in _modules("lpr_tpu")
                     if MAPPED.get(m, m) not in port)
    assert missing == []
    assert all(v in port for v in MAPPED.values())


def test_new_modules_import_neither_jax_nor_yaml():
    for rel in ("config.py", "parallel/mesh.py", "parallel/multiproc.py",
                "parallel/collectives.py", "utils/autobatch.py",
                "utils/observability.py", "tools/validate_autobatch.py"):
        with open(os.path.join(ROOT, "lpr_tpu_torch", rel)) as f:
            src = f.read()
        for word in ("import jax", "from jax", "import yaml", "from yaml",
                     "import lpr_tpu\n", "from lpr_tpu.", "import lpr_tpu."):
            assert word not in src, (rel, word)


# ---------------------------------------------------------------- autobatch

def _mm(lib):
    return lambda x: (x @ x).sum()


def _residual(lib):
    tanh = jnp.tanh if lib == "jax" else torch.tanh

    def f(x):
        y = x * 2.0
        z = tanh(y)
        w = tanh(z)
        v = tanh(w)
        return y + v
    return f


@pytest.mark.parametrize("name,shape,lower", [
    ("mm", (128, 128), 128 * 128 * 4 * 2),
    ("residual", (256 * 256,), 3 * 256 * 256 * 4)])
def test_traced_bytes_bounds_and_outputs_match_jax(name, shape, lower):
    """tests/test_utils2.py's two functions: the same lower bounds on the
    peak, and the same output bytes as the JAX estimate."""
    fn = {"mm": _mm, "residual": _residual}[name]
    jp, jo = j_traced(fn("jax"), jax.ShapeDtypeStruct(shape, np.float32))
    tp, to = traced_bytes(fn("torch"), torch.empty(shape))
    assert tp >= lower and jp >= lower
    assert to == jo


def test_traced_bytes_counts_a_view_once_and_frees_the_dead():
    def f(x):
        v = x.view(-1)[:10]          # a view: no new storage
        y = x + 1                    # 4 KiB, freed at the next line
        del y
        return v * 2
    peak, out = traced_bytes(f, torch.empty(32, 32))
    assert peak == 32 * 32 * 4 * 2       # x and y; y gone before v * 2
    assert out == 40


def test_autobatch_power_of_two_monotone_in_memory():
    from lpr_tpu_torch.models.lpsr import LPSR, LPSRConfig, lpsr_init

    cfg = LPSRConfig(num_features=8, growth_rate=4, num_blocks=2,
                     num_layers=2)
    model = LPSR(lpsr_init(torch.Generator().manual_seed(0), cfg), cfg)
    got = [autobatch(lambda m, x: m(x), model, (32, 192, 3),
                     hbm_bytes=hb) for hb in (2 ** 24, 2 ** 26, 2 ** 28,
                                              2 ** 34)]
    assert all(b & (b - 1) == 0 for b in got)
    assert got == sorted(got) and got[0] < got[-1] == 1024
    with pytest.raises(ValueError, match="hbm_bytes"):
        autobatch(lambda m, x: m(x), model, (32, 192, 3))
    # a tree of tensors in place of a module
    w = {"w": torch.ones(3, 8)}
    b = autobatch(lambda p, x: x @ p["w"], w, (3,), hbm_bytes=2 ** 20,
                  max_batch=64)
    assert b == 64


# ------------------------------------------------------------ observability

def test_model_summary_counts_equal_jax():
    from lpr_tpu.models import yolo as jy
    from lpr_tpu.utils.observability import model_summary as j_summary
    from lpr_tpu_torch.models import yolo as ty

    jm = jy.build_yolo(jy.char_ocr_spec(), ckpt_anchors=np.ones((1, 2, 2)),
                       strides=(8,))
    init = jm.init                   # the counts need the shapes only
    jm.init = lambda k: jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                     jax.eval_shape(init, k))
    tm = ty.build_yolo(ty.char_ocr_spec(), ckpt_anchors=np.ones((1, 2, 2)),
                       strides=(8,))
    assert tobs.model_summary(tm) == j_summary(jm)


def test_meters_sync_and_profile_trace(tmp_path):
    tobs.device_sync({"a": torch.ones(1), "b": None})    # CPU: nothing
    logdir = str(tmp_path / "trace")
    with tobs.profile_trace(logdir) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == logdir and any(f.endswith(".json") for f in os.listdir(d))
    # a trace that cannot be written raises (the JAX context swallows a
    # failure to stop)
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(Exception):
        with tobs.profile_trace(str(blocker / "sub")):
            torch.ones(2) + 1


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("kind", sorted(tc.REGISTRY))
def test_config_round_trip_and_cross_read(kind, tmp_path):
    """Every kind: the port's file loads in the port and in JAX to equal
    fields, JAX's loads in the port, and the text is safe_dump's."""
    tcfg, jcfg = tc.REGISTRY[kind](), jc.REGISTRY[kind]()
    changed = {}
    for f in dataclasses.fields(tcfg):      # off the defaults
        v = getattr(tcfg, f.name)
        if isinstance(v, bool):
            changed[f.name] = not v
        elif isinstance(v, int):
            changed[f.name] = v + 1
        elif isinstance(v, float):
            changed[f.name] = v * 0.5 + 0.125
    tcfg = dataclasses.replace(tcfg, **changed)
    jcfg = dataclasses.replace(jcfg, **changed)
    tp, jp = str(tmp_path / "t.yaml"), str(tmp_path / "j.yaml")
    tc.save_config(tp, tcfg)
    jc.save_config(jp, jcfg)
    assert tc.load_config(tp) == tcfg
    assert tc.load_config(jp) == tcfg
    assert jc.load_config(tp) == jcfg
    with open(tp) as f:
        text = f.read()
    assert text == yaml.safe_dump(yaml.safe_load(text), sort_keys=False)


def test_config_reader_takes_safe_dumps_subset(tmp_path):
    doc = {"kind": "x", "values": {
        "a": [[1, 2], [3, [4, 5]]], "e": [], "n": None, "t": True,
        "s": ["yes", "a'b", "1.5", "-x", "plain text", ""],
        "f": [1e-6, float("inf"), -2.5, 3.0], "m": {}}}
    text = yaml.safe_dump(doc, sort_keys=False)
    assert tc.load(text) == yaml.safe_load(text)
    assert tc.dump(doc) == text


def test_config_unknown_dtype_raises(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("kind: lpsr_train\nvalues:\n  lr: 0.01\n"
                 "  compute_dtype: torch.float8_e4m3fn\n")
    with pytest.raises(ValueError, match="unknown dtype"):
        tc.load_config(str(p))
    # the JAX loader takes float32 for it
    assert jc.load_config(str(p)).compute_dtype == jnp.float32
    p.write_text("kind: lpsr_train\nvalues:\n"
                 "  compute_dtype: <class 'jax.numpy.bfloat16'>\n")
    assert tc.load_config(str(p)).compute_dtype == torch.bfloat16


@pytest.mark.parametrize("args", [["--model", "det", "--imgsz", "64"],
                                  ["--model", "lpsr", "--dtype", "bf16"],
                                  ["--model", "det", "--imgsz", "64",
                                   "--train"]])
def test_validate_autobatch_main_on_cpu(args, capsys):
    """The tool's line on the CPU: the estimate, and "not measured" where
    only the card can say."""
    import json

    from lpr_tpu_torch.tools import validate_autobatch

    assert validate_autobatch.main(args + ["--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["estimate_bytes_per_sample"] > 0
    assert rec["ratio"] is None and "not measured" in rec["measured"]
