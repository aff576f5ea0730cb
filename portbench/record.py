"""What a run hands the metric readers (``metrics/<name>.py``).

Each reader is a module with ``read(run) -> float | None``: None where it
finds nothing to read, and the harness then leaves the metric out.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from portbench.trace import Trace


@dataclasses.dataclass
class Run:
    setup_s: float  # process start to the first timed call
    window_s: float  # first timed call's start to the last one's end
    chunk: int  # frames a call
    calls: List[dict]  # each timed call's spans (s): call, loader_wait, ...
    trace: Optional[Trace] = None  # the traced stretch (--trace 1)
    traced_frames: int = 0
    launches: List[dict] = dataclasses.field(default_factory=list)  # the traced frames'
    notes: List[str] = dataclasses.field(default_factory=list)  # printed on stderr

    @property
    def frames(self) -> int:
        return len(self.calls) * self.chunk

    def mean_ms(self, span: str) -> Optional[float]:
        if not self.calls:
            return None
        return 1e3 * sum(c[span] for c in self.calls) / len(self.calls)
