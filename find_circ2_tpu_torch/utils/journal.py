"""Resume journal: batch-level restartability for streaming runs.

The reference has no checkpointing — a failed run is rerun from scratch
(SURVEY.md §5). Here every processed read batch appends one JSONL record
with its per-read calls; on resume, completed batches replay from the
journal (junction aggregation is associative and commutative, so replay
order is irrelevant) and only unprocessed batches hit the device.
"""

from __future__ import annotations

import dataclasses
import json
import os

from find_circ2_tpu_torch.models.oracle import ReadCall


@dataclasses.dataclass
class FastBatch:
    """Compact journal record for the native streaming path: non-junction
    reads are journaled as per-status counts (they carry no junction
    fields), junction/multi-routed reads as full calls."""
    n_reads: int
    counts: dict          # status(int as str in JSON) -> count
    calls: list           # list[ReadCall]


class RunJournal:
    def __init__(self, path: str | os.PathLike,
                 meta: dict | None = None) -> None:
        """`meta` (e.g. {"nproc": N, "proc_id": i}) is written as a
        header record and validated on resume: replaying a journal
        written under a different run shape (a different process count
        or rank — whose batch ids mean different reads) fails loudly
        instead of silently corrupting counts."""
        self.path = os.fspath(path)
        self.meta = meta
        self._valid_bytes: int | None = None  # set by completed_batches

    def completed_batches(self) -> dict[int, list[ReadCall]]:
        """Map of batch_id -> recorded calls for all complete records.

        Also notes the byte offset of the last complete record so a torn
        tail (crash mid-append) is truncated before the next append —
        otherwise the new record would concatenate onto the partial line
        and both would be lost.
        """
        out: dict[int, list[ReadCall]] = {}
        self._valid_bytes = 0
        if not os.path.exists(self.path):
            return out
        with open(self.path, "rb") as fh:
            data = fh.read()
        parts = data.split(b"\n")
        offset = 0
        # Only newline-terminated lines can be complete records; the
        # final segment (after the last newline) is a torn tail if
        # non-empty.
        for raw in parts[:-1]:
            line = raw.strip()
            if line:
                try:
                    rec = json.loads(line)
                    if "meta" in rec:
                        if self.meta is not None \
                                and rec["meta"] != self.meta:
                            raise ValueError(
                                f"journal {self.path} was written by a "
                                f"run with meta {rec['meta']}, this run "
                                f"has {self.meta}: batch ids are not "
                                "comparable; delete the journal or rerun "
                                "with the original sharding")
                        offset += len(raw) + 1
                        continue
                    calls = [ReadCall(**c) for c in rec["calls"]]
                    if "counts" in rec:
                        out[rec["batch"]] = FastBatch(
                            n_reads=rec["n_reads"],
                            counts={int(k): v for k, v
                                    in rec["counts"].items()},
                            calls=calls)
                    else:
                        out[rec["batch"]] = calls
                except (json.JSONDecodeError, KeyError, TypeError):
                    break  # torn/corrupt record: reprocess from here
            offset += len(raw) + 1
        self._valid_bytes = offset
        return out

    def record(self, batch_id: int, calls: list[ReadCall]) -> None:
        self._append({"batch": batch_id,
                      "calls": [dataclasses.asdict(c) for c in calls]})

    def record_fast(self, batch_id: int, fast: FastBatch) -> None:
        self._append({"batch": batch_id, "n_reads": fast.n_reads,
                      "counts": fast.counts,
                      "calls": [dataclasses.asdict(c) for c in fast.calls]})

    def _append(self, rec: dict) -> None:
        if self._valid_bytes is None:
            self.completed_batches()
        if (self._valid_bytes is not None and os.path.exists(self.path)
                and os.path.getsize(self.path) > self._valid_bytes):
            with open(self.path, "r+b") as fh:
                fh.truncate(self._valid_bytes)
        write_header = self.meta is not None and not self._valid_bytes
        with open(self.path, "at", encoding="ascii") as fh:
            if write_header:
                fh.write(json.dumps({"meta": self.meta}) + "\n")
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        if self._valid_bytes is not None:
            self._valid_bytes = os.path.getsize(self.path)
