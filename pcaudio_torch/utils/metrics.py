"""Experiment result files in the reference's schema, with a provenance
side-file (the result-file part of ``pcaudio/utils/metrics.py``)."""
from __future__ import annotations

import json
import os
from typing import Dict


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
