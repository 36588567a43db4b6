"""GOP scheduling + resumable transcode jobs: the port's copy of
jmcodec_tpu/pipeline/gop.py, on the port's own codec/h264/nal.py. The
manifest's JSON schema is the same, so a job started by either package's
transcode tool resumes under the other's.

The reference had no checkpoint/resume; its nearest analogs were the EOF-drain
protocol and SPS/PPS export. Here long transcode jobs are split at closed-GOP
boundaries (IDR-led pictures) into independent work units recorded in a JSON
manifest: a crashed/preempted host's pending GOPs are simply reassigned, and
resume skips completed ones.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from ..codec.h264 import nal as NAL


def split_gops(stream: bytes) -> List[Tuple[int, int]]:
    """Byte ranges of closed GOPs in an Annex-B stream: each GOP starts at the
    start code preceding an IDR slice (including any SPS/PPS/SEI directly
    before it) and runs to the next GOP's start."""
    idr_cuts: List[int] = []
    aux_start: Optional[int] = None  # earliest SPS/PPS/SEI before next slice
    for s, e in NAL.split_annexb(stream):
        typ = stream[s] & 0x1F
        sc = s - 3
        if sc > 0 and stream[sc - 1] == 0:
            sc -= 1
        if typ in (6, 7, 8, 9):  # SEI/SPS/PPS/AUD travel with the next IDR
            if aux_start is None:
                aux_start = sc
        elif typ == 5:
            first_mb_zero = (stream[s + 1] & 0x80) != 0
            if first_mb_zero:
                idr_cuts.append(aux_start if aux_start is not None else sc)
            aux_start = None
        else:
            aux_start = None
    if not idr_cuts:
        return [(0, len(stream))]
    ranges = []
    for i, c in enumerate(idr_cuts):
        end = idr_cuts[i + 1] if i + 1 < len(idr_cuts) else len(stream)
        ranges.append((c, end))
    return ranges


@dataclass
class GopJob:
    index: int
    byte_start: int
    byte_end: int
    status: str = "pending"  # pending | running | done | failed
    worker: Optional[str] = None
    output: Optional[str] = None
    updated: float = 0.0


@dataclass
class TranscodeManifest:
    """Per-GOP work ledger on shared storage; resume = skip done GOPs."""

    input_path: str
    output_dir: str
    jobs: List[GopJob] = field(default_factory=list)

    @staticmethod
    def create(input_path: str, output_dir: str,
               stream: Optional[bytes] = None) -> "TranscodeManifest":
        data = stream if stream is not None else open(input_path, "rb").read()
        m = TranscodeManifest(input_path, output_dir)
        for i, (s, e) in enumerate(split_gops(data)):
            m.jobs.append(GopJob(i, s, e))
        return m

    # ---- persistence ----

    def path(self) -> str:
        return os.path.join(self.output_dir, "manifest.json")

    def save(self) -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        tmp = self.path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"input": self.input_path,
                       "jobs": [asdict(j) for j in self.jobs]}, f, indent=1)
        os.replace(tmp, self.path())

    @staticmethod
    def load(output_dir: str) -> "TranscodeManifest":
        with open(os.path.join(output_dir, "manifest.json")) as f:
            d = json.load(f)
        m = TranscodeManifest(d["input"], output_dir)
        m.jobs = [GopJob(**j) for j in d["jobs"]]
        return m

    # ---- scheduling ----

    @contextlib.contextmanager
    def _locked(self):
        """Exclusive manifest transaction: flock + reload-on-entry so
        concurrent workers never double-claim or overwrite each other's
        status (lost-update fix)."""
        os.makedirs(self.output_dir, exist_ok=True)
        lock_path = os.path.join(self.output_dir, "manifest.lock")
        with open(lock_path, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                if os.path.exists(self.path()):
                    self.jobs = TranscodeManifest.load(self.output_dir).jobs
                yield
                self.save()
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def claim(self, worker: str) -> Optional[GopJob]:
        """Claim the next pending GOP (also reclaims stale 'running' jobs
        older than 10 minutes — the failure-detection hook)."""
        now = time.time()
        with self._locked():
            for j in self.jobs:
                if j.status == "pending" or (
                        j.status == "running" and now - j.updated > 600):
                    j.status = "running"
                    j.worker = worker
                    j.updated = now
                    return j
        return None

    def complete(self, index: int, output: str) -> None:
        with self._locked():
            j = self.jobs[index]
            j.status = "done"
            j.output = output
            j.updated = time.time()

    def fail(self, index: int) -> None:
        with self._locked():
            j = self.jobs[index]
            j.status = "failed"
            j.updated = time.time()

    def pending(self) -> int:
        return sum(j.status in ("pending", "running", "failed")
                   for j in self.jobs)

    def done(self) -> int:
        return sum(j.status == "done" for j in self.jobs)
