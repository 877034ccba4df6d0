"""What a driver is given and what its window gives back."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass
class Run:
    """One run of one cell: its name, seed, configuration file and mix file
    as read, and the device it runs on."""

    name: str
    seed: int
    config: dict
    workload: dict
    device: torch.device
    marks: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note the end of a phase of set-up (printed on standard error)."""
        self.marks.append((name, time.perf_counter()))

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


@dataclasses.dataclass
class Window:
    """A measured or traced window: its seconds (from its start to its
    last completed call), the calls attempted and failed, the cell's
    end-to-end numbers, the counts of work the per-layer readers take, and
    host spans (seconds each) by name."""

    seconds: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    counts: Dict[str, float]
    spans: Dict[str, List[float]]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
