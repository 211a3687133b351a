"""Local run-artifact registry (counterpart of
``lpr_tpu/utils/registry.py``, the substitute for the reference's Weights &
Biases tracking, ``yolov5/utils/loggers/wandb/wandb_utils.py``), plain
Python.  The same directories give the same ``dataset_fingerprint`` and the
manifests keep the JAX package's layout, so each package reads the other's
``runs/``.

- ``runs/<project>/run-NNNN/run.json`` — one manifest per run: resolved
  config, dataset fingerprint (a hash over file names and sizes),
  checkpoint lineage (sha256-versioned artifacts with aliases), the parent
  run (when resumed) and a final summary.
- ``RunRegistry.latest(project)`` + ``Run.artifact(alias)`` — resume from a
  run: a new run finds the previous run's ``latest`` checkpoint and records
  the parent run's id.

Manifests are JSON written atomically, safe to read while a run is live.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)
    os.replace(tmp, path)


def dataset_fingerprint(dirs: Sequence[str], max_files: int = 200_000) -> str:
    """Content-identity hash of one or more dataset directories: sha256 over
    the sorted (relative path, size) listing.  Cheap (no file reads) but
    catches the practical drift cases — added/removed/renamed/resized files —
    the same role W&B's dataset artifact digest plays."""
    h = hashlib.sha256()
    entries: List[str] = []
    truncated = False
    for d in dirs:
        if truncated:
            break
        if not d or not os.path.isdir(d):
            entries.append(f"missing:{d}")
            continue
        root = os.path.abspath(d)
        for dirpath, dirnames, names in os.walk(root):
            # sort the walk so the (possibly truncated) entry set is the
            # same on every filesystem — a fingerprint that depends on
            # readdir order can't detect drift
            dirnames.sort()
            for n in sorted(names):
                if len(entries) >= max_files:
                    truncated = True
                    break
                p = os.path.join(dirpath, n)
                try:
                    sz = os.path.getsize(p)
                except OSError:
                    sz = -1
                entries.append(f"{os.path.relpath(p, root)}:{sz}")
            if truncated:
                break
    if truncated:
        entries.append(f"truncated:{max_files}")
    for e in sorted(entries):
        h.update(e.encode())
    return h.hexdigest()[:16]


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


@dataclasses.dataclass
class Run:
    """One tracked training run: a directory + a mutable manifest."""

    dir: str
    manifest: Dict

    @property
    def id(self) -> str:
        return self.manifest["run_id"]

    @property
    def path(self) -> str:
        return os.path.join(self.dir, "run.json")

    def save(self) -> None:
        _atomic_write_json(self.path, self.manifest)

    # -- artifacts ------------------------------------------------------
    def log_artifact(self, path: str, name: str = "checkpoint",
                     aliases: Sequence[str] = ("latest",),
                     step: Optional[int] = None,
                     metrics: Optional[Dict] = None) -> Dict:
        """Record a checkpoint (or any file) as a versioned artifact.  Each
        distinct content hash of ``name`` gets the next version number
        (W&B ``v0, v1, ...``); aliases move to the newest version carrying
        them (W&B ``latest``/``best`` alias semantics)."""
        digest = file_sha256(path)
        arts = self.manifest.setdefault("artifacts", [])
        same = [a for a in arts if a["name"] == name]
        for a in same:  # dedupe identical content: re-alias, don't re-version
            if a["sha256"] == digest:
                a["aliases"] = sorted(set(a["aliases"]) | set(aliases))
                self._steal_aliases(a, same, aliases)
                self.save()
                return a
        entry = {
            "name": name,
            "version": len(same),
            "path": os.path.abspath(path),
            "sha256": digest,
            "bytes": os.path.getsize(path),
            "aliases": sorted(aliases),
            "step": step,
            "metrics": metrics or {},
            "logged_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        arts.append(entry)
        self._steal_aliases(entry, same, aliases)
        self.save()
        return entry

    @staticmethod
    def _steal_aliases(winner: Dict, others: List[Dict],
                       aliases: Sequence[str]) -> None:
        for o in others:
            if o is winner:
                continue
            o["aliases"] = [a for a in o["aliases"] if a not in aliases]

    def artifact(self, alias: str = "latest",
                 name: str = "checkpoint") -> Optional[Dict]:
        for a in reversed(self.manifest.get("artifacts", [])):
            if a["name"] == name and alias in a["aliases"]:
                return a
        return None

    def finish(self, summary: Optional[Dict] = None) -> None:
        self.manifest["finished_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        if summary:
            self.manifest["summary"] = {
                k: (float(v) if isinstance(v, (int, float)) else v)
                for k, v in summary.items()
            }
        self.save()


class RunRegistry:
    """Directory-per-run registry rooted at ``root`` (default ``runs/``)."""

    def __init__(self, root: str = "runs"):
        self.root = root

    def _project_dir(self, project: str) -> str:
        return os.path.join(self.root, project)

    def runs(self, project: str) -> List[str]:
        d = self._project_dir(project)
        if not os.path.isdir(d):
            return []
        return sorted(n for n in os.listdir(d)
                      if n.startswith("run-")
                      and os.path.isfile(os.path.join(d, n, "run.json")))

    def load(self, project: str, run_name: str) -> Run:
        d = os.path.join(self._project_dir(project), run_name)
        with open(os.path.join(d, "run.json")) as f:
            return Run(dir=d, manifest=json.load(f))

    def latest(self, project: str,
               with_artifact: Optional[str] = None) -> Optional[Run]:
        """Newest run; with ``with_artifact=<alias>``, the newest run that
        has checkpointed under that alias.  Multi-host resume resolution
        MUST pass an alias: rank 0 creates the new (artifact-less) run dir
        concurrently with other ranks resolving their warm-start, so 'the
        newest run dir' is rank-order-dependent while 'the newest run with
        a latest checkpoint' is deterministic."""
        for name in reversed(self.runs(project)):
            run = self.load(project, name)
            if with_artifact is None or run.artifact(with_artifact):
                return run
        return None

    def new_run(self, project: str, config: Dict,
                dataset_dirs: Sequence[str] = (),
                resume_from: Optional[Run] = None) -> Run:
        """Open a run directory and write its initial manifest.  When
        ``resume_from`` is given, the parent's id and its ``latest``
        checkpoint are recorded as this run's lineage."""
        existing = self.runs(project)
        seq = (int(existing[-1].split("-")[1]) + 1) if existing else 0
        name = f"run-{seq:04d}"
        d = os.path.join(self._project_dir(project), name)
        os.makedirs(d, exist_ok=True)
        manifest = {
            "run_id": f"{project}/{name}",
            "project": project,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "config": config,
            "dataset_fingerprint": (dataset_fingerprint(dataset_dirs)
                                    if dataset_dirs else None),
            "dataset_dirs": [os.path.abspath(x) for x in dataset_dirs],
            "parent": None,
            "artifacts": [],
        }
        if resume_from is not None:
            parent_ckpt = resume_from.artifact("latest")
            manifest["parent"] = {
                "run_id": resume_from.id,
                "checkpoint": parent_ckpt["path"] if parent_ckpt else None,
                "sha256": parent_ckpt["sha256"] if parent_ckpt else None,
            }
        run = Run(dir=d, manifest=manifest)
        run.save()
        return run

    def resume_checkpoint(self, project: str,
                          alias: str = "latest") -> Optional[str]:
        """Path of the newest aliased checkpoint, or None — the
        ``--resume`` entry point (W&B ``download_model_artifact``).
        Runs without the alias are skipped, so a concurrently-created
        (not-yet-checkpointed) run never shadows the real resume target."""
        run = self.latest(project, with_artifact=alias)
        if run is None:
            return None
        return run.artifact(alias)["path"]
