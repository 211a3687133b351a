"""What decides ``correct``: the served answers of a sample of the
window's requests, drawn from the seed, judged against the plain float32
reference (``lprbench/ref/``) stage by stage, each stage on the served
output of the one before it.  Each number is a mean over the sample's
plates or strings: the widest gap of a plate swings from seed to seed (a
near-tie in NMS, a glyph at the char threshold) and separated the
program's bf16 from the float8 control by less than 3x, the means by 3.3x
or more.  (The reference's own chain, its box, angle and SR image, read
end to end against the served strings and SR images, does not separate
them at all: these plates' strings and SR images follow the box, which
bf16 moves by 1-2 % of a side; ``lprbench/readings.py`` prints it.)

- the top plates, from the frames: the served plates have to be the
  reference's ``max_plates`` largest detections.  Each served plate is
  matched to the reference top plate of largest IoU (at least
  ``MATCH_IOU``), one to one.  A plate served and not matched, or a
  reference top plate not served, counts in ``plates_unexplained``
  unless its score lies within ``NEAR_THRESHOLD`` of the confidence
  threshold, where rounding can carry it across;
- detection, on each matched plate: ``box_err_mean``, the widest
  box-coordinate gap as a share of the reference plate's longer side, and
  ``score_err_mean``, the score gap;
- crops, deskew and LPSR, on each served box: ``sr_err_mean``, the mean
  gap of the served SR image to the reference's at the deskew angle
  nearest it among those the ill-conditioned orientation allows
  (``ref/pipeline.py`` ``THETA_SPAN``);
- the char OCR and char NMS, on the served box's raw crop at that angle and
  on the served SR image: ``text_dist``, the strings' edit distance over
  the longer string's length.

A request that failed or was never answered makes the run not correct.
The limits live in ``lprbench/limits/<configuration>.json``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MATCH_IOU = 0.5
# A plate whose score lies within this of the confidence threshold may
# cross it under rounding (the widest score gap of sound runs read 0.016
# over 16 seeds on the card), so its absence on one side is explained.
NEAR_THRESHOLD = 0.05


def _iou(a, b) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(ua - inter, 1e-9)


def _key(i: int, plates) -> tuple:
    return (i, tuple(tuple(np.round(np.asarray(p["box"], np.float64), 4))
                     for p in plates))


def sample(requests: Sequence, n: int, seed: int) -> List:
    """``n`` of the answered requests, drawn from ``seed``, in order."""
    rng = np.random.RandomState((seed * 7919 + 17) % 2**32)
    k = min(n, len(requests))
    idx = sorted(rng.choice(len(requests), size=k, replace=False))
    return [requests[i] for i in idx]


def _match(plates, top) -> dict:
    """Served plate index -> reference top plate index, one to one, each
    pair of IoU ``MATCH_IOU`` or more, the largest IoU first."""
    pairs = sorted(((_iou(p["box"], r["box"]), i, j)
                    for i, p in enumerate(plates)
                    for j, r in enumerate(top)), reverse=True)
    out, used = {}, set()
    for v, i, j in pairs:
        if v < MATCH_IOU:
            break
        if i not in out and j not in used:
            out[i] = j
            used.add(j)
    return out


def judge(served: Sequence, frames: np.ndarray, ref, limits: Dict[str, float]
          ) -> Dict[str, float]:
    """``served``: (frame index, served plates) pairs, each plate a dict
    with ``box``, ``score``, ``sr`` (32, 192[, 1]), ``text``, ``text_sr``.
    Returns each number of the module's list over all of them."""
    conf = ref.cfg["det_conf"]
    idx = sorted({i for i, _ in served})
    dets = dict(zip(idx, ref.detect(frames[idx])))
    # one reference read for each distinct (frame, served boxes)
    reads = {}
    for i, plates in served:
        k = _key(i, plates)
        if plates and k not in reads:
            reads[k] = (i, plates)
    order = list(reads)
    got = {}
    for s in range(0, len(order), 8):
        chunk = [reads[k] for k in order[s:s + 8]]
        out = ref.read(frames[[i for i, _ in chunk]],
                       [[p["box"] for p in pl] for _, pl in chunk],
                       [[p["sr"] for p in pl] for _, pl in chunk])
        got.update(zip(order[s:s + 8], out))
    box, score, sr, dist = [], [], [], []
    unexplained = 0
    for i, plates in served:
        top = dets[i]["top"]
        match = _match(plates, top)
        for k, p in enumerate(plates):
            if k not in match:
                unexplained += p["score"] > conf + NEAR_THRESHOLD
                continue
            j = match[k]
            r = top[j]
            side = max(r["box"][2] - r["box"][0], r["box"][3] - r["box"][1])
            gap = np.abs(np.asarray(p["box"], np.float64) - r["box"]).max()
            box.append(float(gap / max(side, 1.0)))
            score.append(abs(float(p["score"]) - r["score"]))
        matched = set(match.values())
        unexplained += sum(1 for j, r in enumerate(top) if j not in matched
                           and r["score"] > conf + NEAR_THRESHOLD)
        if not plates:
            continue
        for p, cands in zip(plates, got[_key(i, plates)]):
            img = np.asarray(p["sr"], np.float32).reshape(
                cands[0]["sr"].shape)
            gaps = [float(np.abs(img - q["sr"]).mean()) for q in cands]
            k = int(np.argmin(gaps))
            sr.append(gaps[k])
            for kind in ("text", "text_sr"):
                dist.append(edit_share(p[kind], cands[k][kind]))

    def mean(xs):
        return float(np.mean(xs)) if xs else 0.0
    return {"plates_unexplained": float(unexplained),
            "box_err_mean": mean(box), "score_err_mean": mean(score),
            "sr_err_mean": mean(sr), "text_dist": mean(dist)}


def edit_share(a: str, b: str) -> float:
    """Levenshtein distance of two strings over the longer one's length
    (0 for two empty strings)."""
    if not a and not b:
        return 0.0
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1] / max(len(a), len(b))


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> bool:
    """No request failed and every number with a limit within it."""
    return failed == 0 and all(numbers[k] <= v for k, v in limits.items())
