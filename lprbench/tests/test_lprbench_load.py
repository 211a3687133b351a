"""The load generator: the open loop's schedule (every camera at the
cell's rate from a seeded phase, each send within its jitter of the
period's grid, the same seed the same sends), and every traffic file's
driver and route found by name and driving a stand-in server for a
window; every per-layer metric found by name too."""

import json
from concurrent.futures import Future

import numpy as np
import pytest

from lprbench import load, run
from lprbench.drivers.open import schedule
from lprbench.tests.conftest import ROOT, manifest

MIX = {"cameras": 32, "jitter": 0.1}
TRAFFIC = sorted(p.stem for p in (ROOT / "lprbench" / "traffic").glob(
    "*.json"))


def test_schedule_keeps_the_rate_and_the_jitter():
    sends = schedule(MIX, 400.0, 10.0, 2**31 + 3)
    assert sends == sorted(sends)
    assert abs(len(sends) - 4000) <= 32
    period = 32 / 400.0
    for cam in (0, 17, 31):
        t = np.array([d for d, c in sends if c == cam])
        steps = np.diff(t)
        assert np.all(np.abs(steps - period) <= 2 * 0.1 * period + 1e-9)
    assert sends == schedule(MIX, 400.0, 10.0, 2**31 + 3)
    assert sends != schedule(MIX, 400.0, 10.0, 2**31 + 4)


class _Server:
    """Answers every frame at once with its own first pixel."""

    def submit(self, frame):
        f = Future()
        f.set_result(int(frame[0, 0, 0]))
        return f


@pytest.mark.parametrize("name", TRAFFIC)
def test_each_traffic_file_drives_a_server_by_name(name):
    mix = json.loads((ROOT / "lprbench" / "traffic" / f"{name}.json")
                     .read_text())
    mix = dict(mix, ramp_s=0.1, cameras=4, clients=2)
    frames = np.arange(mix["distinct_frames"], dtype=np.uint8)[
        :, None, None, None] * np.ones((1, 2, 2, 3), np.uint8)
    route = load.route(mix, _Server(), frames)
    r = load.drive(route, mix, 0.4, 2**31 + 9, rate_fps=40.0)
    window = r.in_window("due")
    assert len(window) >= 8
    assert all(q.answered() and q.result == q.frame for q in window)
    assert all(q.sent >= q.due for q in window)


def test_every_per_layer_metric_has_a_reader():
    for m in manifest()["per_layer"]:
        assert callable(run._reader(m["name"])), m["name"]
