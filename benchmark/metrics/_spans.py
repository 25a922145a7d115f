"""What the readers of the port's own spans share. Under ``--trace 1``
the window runs under ``torch.profiler``, which makes the port's spans
live with its tracer disabled: the port's span ring
(``sparkucx_tpu_torch.utils.trace.GLOBAL_TRACER``) then holds the
traced window's spans and nothing from set-up. Read-path phases come
from each read's exchange ledger (``utils/anatomy.fold_tracer``, keyed
by the trace id of the read's ``shuffle.exchange`` wall span); device
times from the spans' CUDA events (``Span.device_ms``). Each reader
returns None where the ring holds none of its spans, as with a program
that records none."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from sparkucx_tpu_torch.utils.anatomy import WALL_SPAN, fold_tracer
from sparkucx_tpu_torch.utils.trace import GLOBAL_TRACER


def phase_median(phase: str) -> Optional[float]:
    """The median over the window's reads of the milliseconds the read's
    exchange ledger gives ``phase`` (0 for a read whose ledger lacks
    it); None where no ledger holds the phase."""
    ledgers = [fold_tracer(GLOBAL_TRACER, s.attrs["trace"])
               for s in GLOBAL_TRACER.spans(WALL_SPAN)]
    ledgers = [led for led in ledgers if led is not None]
    if not any(phase in led.phases_ms for led in ledgers):
        return None
    return float(np.median([led.phases_ms.get(phase, 0.0)
                            for led in ledgers]))


def device_ms_per(names: Iterable[str], per: str) -> Optional[float]:
    """The device milliseconds of the ring's spans named ``names``,
    summed, per span named ``per`` (a read's decode, a training step);
    None where either is missing."""
    names = set(names)
    spans = GLOBAL_TRACER.spans()
    times = [s.device_ms for s in spans if s.name in names]
    times = [t for t in times if t is not None]
    count = sum(1 for s in spans if s.name == per)
    if not times or not count:
        return None
    return float(sum(times)) / count
