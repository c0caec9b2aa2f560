"""The device trace of a window: torch.profiler over the card's kernels,
bracketed by two marker kernels.

Late in a long run torch.profiler drops a session's first device events,
so only the events between two `torch.cuda._sleep` markers count: the
bracketing of the port's `chip_smoke.device_ms`, copied here with its
raw-event reader (`prof.events()` would build the host op tree first,
tens of seconds for a traced serving window)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARK_CYCLES = 1000


def kernel_name(name: str) -> str:
    """A device event's kernel name without return type, namespace and
    arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def device_events(prof) -> List[Tuple[str, int, int]]:
    """The card's kernel, copy and set intervals of a finished profiler
    run: [(name, start ns, end ns)], from the raw Kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def is_copy(name: str) -> bool:
    """A copy or set event rather than a kernel ("Memcpy HtoD ...",
    "Memset ...")."""
    return name.startswith(("Memcpy", "Memset"))


def union_ns(spans: List[Tuple[int, int]]) -> int:
    """Nanoseconds covered by at least one of the intervals."""
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps_ns(spans: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Window:
    """What the trace saw between the markers: every device event
    (kernel name, start, end in ns of the trace's clock), the markers'
    bounds and the host clock's reading when the first marker was
    launched, to place host spans on the device's timeline."""
    events: List[Tuple[str, int, int]] = field(default_factory=list)
    lo_ns: int = 0
    hi_ns: int = 0
    host_t0: float = 0.0
    note: Optional[str] = None

    @property
    def window_s(self) -> float:
        return (self.hi_ns - self.lo_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.events]) / 1e9

    def seconds_by_kernel(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.events:
            k = kernel_name(name)
            out[k] = out.get(k, 0.0) + (e - s) / 1e9
        return out

    def seconds_matching(self, *needles: str) -> float:
        """Device seconds of the events whose name holds any needle."""
        return sum((e - s) / 1e9 for name, s, e in self.events
                   if any(n in name for n in needles))

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals as (host-clock start, seconds)."""
        spans = [(s, e) for _, s, e in self.events]
        return [(self.host_t0 + (a - self.lo_ns) / 1e9, (b - a) / 1e9)
                for a, b in gaps_ns(spans, self.lo_ns, self.hi_ns)]


class Tracer:
    """torch.profiler over the card's activity, with the marker kernels.
    `start()` while no other thread launches work on the card, `mark()`
    at the window's start and end; `stop()` -> `Window`.  A window in
    which the profiler kept copies but no kernel is reported as lost
    (`Window.note`, no events), never as an idle card."""

    def __init__(self):
        import torch

        self.torch = torch
        self.marker = self._marker_name()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.host_t0 = 0.0

    def _marker_name(self) -> str:
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(4):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        names = {n for n, _, _ in device_events(prof)}
        if len(names) != 1:
            raise RuntimeError(f"torch.cuda._sleep gave the device events {names}")
        return names.pop()

    def start(self, lead: int = 256) -> None:
        """Start tracing; `lead` one-element adds go first, since the
        profiler may drop a session's first device events."""
        self.prof.__enter__()
        one = self.torch.zeros(1, device="cuda")
        for _ in range(lead):
            one.add_(1)

    def mark(self, host_t: Optional[float] = None) -> None:
        if host_t is not None:
            self.host_t0 = host_t
        self.torch.cuda._sleep(MARK_CYCLES)

    def stop(self) -> Window:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = device_events(self.prof)
        marks = sorted((s, e) for n, s, e in events if n == self.marker)
        if len(marks) < 2:
            return Window(note=f"the profiler kept {len(marks)} of the 2 marker kernels")
        lo, hi = marks[0][1], marks[-1][0]
        kept = [ev for ev in events if ev[0] != self.marker and lo <= ev[1] < hi]
        if not any(not is_copy(n) for n, _, _ in kept):
            copies = len(kept)
            return Window(note=f"the profiler kept {copies} copies and sets and no kernel "
                               "between the markers")
        return Window(events=kept, lo_ns=lo, hi_ns=hi, host_t0=self.host_t0)
