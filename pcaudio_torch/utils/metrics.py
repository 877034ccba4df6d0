"""Structured metrics (counterpart of ``pcaudio/utils/metrics.py``): a JSONL
stream of records, and experiment result files in the reference's schema
with a provenance side-file.

A stream's lines are the JAX writer's, byte for byte in form: ``index`` and
``time`` first, then the record's keys, one ``json.dumps`` a line; each
package's ``read_metrics`` reads the other's files.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List


class MetricsWriter:
    """Append-only JSONL metrics stream: each record is written as one line
    with its index in this writer (from 0) and the wall-clock time."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._idx = 0
        self._f = open(path, "a", buffering=1)

    def write(self, record: Dict[str, Any]) -> None:
        rec = {"index": self._idx, "time": time.time(), **record}
        self._f.write(json.dumps(rec) + "\n")
        self._idx += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> List[Dict[str, Any]]:
    """The records of a JSONL stream, blank lines skipped."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def dump_reference_json(result: Dict, path: str) -> None:
    """Write an experiment result dict in the reference's exact on-disk form:
    plain ``json.dump``, keys stringified as the reference scripts' dicts
    are (``Code/pceval.py:103-105,186-192``), so a float rate key reads
    "22050.0"."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f)


def dump_with_provenance(result: Dict, path: str, provenance: Dict) -> str:
    """The reference-schema file at ``path`` (``*.json``) plus a
    ``*.provenance.json`` side-file saying how it was made (engine, device,
    the fused-attention gate, corpus, checkpoint, wall time).  Returns the
    side-file's path."""
    if not path.endswith(".json"):
        raise ValueError(f"{path!r} does not end in .json")
    dump_reference_json(result, path)
    side = path[: -len(".json")] + ".provenance.json"
    with open(side, "w") as f:
        json.dump(provenance, f, indent=1)
        f.write("\n")
    return side
