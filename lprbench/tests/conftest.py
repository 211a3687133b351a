"""Shared set-up of the benchmark's own tests: the repo root on the path,
a tiny copy of each configuration for CPU runs, and the card fixture."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_FRAME_HW = [180, 320]
TINY_DET_HW = [192, 320]
TINY_MIX = {"clients": 4, "distinct_frames": 4, "ramp_s": 0.5,
            "server": {"max_batch": 2, "max_delay_ms": 5.0,
                       "queue_size": 64},
            "check_requests": 8}


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str = "lpr720_rect_bf16", **pipeline) -> dict:
    cfg = json.loads((ROOT / "lprbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["checkpoints"] = {k: str(ROOT / v)
                          for k, v in cfg["checkpoints"].items()}
    return cfg


def tiny(cfg: dict, **pipeline) -> dict:
    """``cfg`` at the tests' frame and detector sizes."""
    out = dict(cfg, frame_hw=list(TINY_FRAME_HW))
    out["pipeline"] = dict(cfg["pipeline"], det_hw=list(TINY_DET_HW),
                           **pipeline)
    return out


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; runs on the card with "
                    "python -m pytest -m cuda lprbench/tests")
    return torch.device("cuda")
