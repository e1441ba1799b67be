"""The traced steps of a run and what the per-layer readers take from
them: ``torch.profiler`` around a few steps at the end of the window, one
profiler session per step, each step inside a ``benchmark.step`` span.
The metrics' steps record CUDA activity only (the kernels, copies and
fills, and the runtime calls that launch them): recording every host op
too doubles a step's wall time.  One more step records CPU activity as
well, for the breakdown's idle gaps by the host op that spans them.  A
step that would remesh is taken untraced first: the remesh has a metric of
its own (``remesh_ms``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

STEP_SPAN = "benchmark.step"
PROFILER_OWN = ("Activity Buffer Request",)   # the profiler's host work
SPLAT_KERNELS = ("splat_fwd_kernel", "splat_fwd_merge_kernel",
                 "splat_bwd_kernel")


@dataclass
class TracedStep:
    window: tuple                         # (start, end) us, profiler clock
    device: List[tuple]                   # (name, start, end) us
    host: List[tuple]                     # (name, start, end) us
    splat_inputs: list = field(default_factory=list)   # per frame


def _events(prof):
    """(device activities: kernels, copies, fills; host events) as (name,
    start us, end us)."""
    dev, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a record_function span also shows on the device's timeline
            if not (getattr(e, "is_user_annotation", False)
                    or e.name == STEP_SPAN):
                dev.append((e.name, s, t))
        elif e.name not in PROFILER_OWN:
            host.append((e.name, s, t))
    return dev, host


def trace_step(run_step, splat_inputs, host_ops: bool = False) -> TracedStep:
    """One step under the profiler (with host_ops, CPU activity too);
    splat_inputs is what the splat yardstick needs for its frames, taken
    before the step."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        with record_function(STEP_SPAN):
            run_step()
    dev, host = _events(prof)
    spans = [h for h in host if h[0] == STEP_SPAN]
    if spans:
        start, end = spans[0][1], max([spans[0][2]] + [d[2] for d in dev])
    else:
        # CUDA activity alone records no host op: the step runs from its
        # first runtime call to its last activity
        ev = dev + host
        start, end = min(e[1] for e in ev), max(e[2] for e in ev)
    dev = [d for d in dev if d[1] >= start and d[2] <= end]
    return TracedStep((start, end), dev, [h for h in host
                                          if h[0] != STEP_SPAN], splat_inputs)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(step: TracedStep):
    """(gap seconds, host op) for each stretch of the step in which the
    card runs nothing, the host op the innermost one spanning the gap's
    middle."""
    iv = sorted((d[1], d[2]) for d in step.device)
    gaps, t = [], step.window[0]
    for s, e in iv:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if step.window[1] > t:
        gaps.append((t, step.window[1]))
    host = np.array([(h[1], h[2]) for h in step.host] or [(0.0, 0.0)])
    names = [h[0] for h in step.host] or ["(none)"]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (s + e)
        inside = np.flatnonzero((host[:, 0] <= mid) & (host[:, 1] >= mid))
        if inside.size:
            k = inside[np.argmin(host[inside, 1] - host[inside, 0])]
            out.append(((e - s) * 1e-6, names[k]))
        else:
            out.append(((e - s) * 1e-6, "(python)"))
    return out


def summary(steps: List[TracedStep],
            host_step: TracedStep) -> Dict[str, object]:
    """busy and window seconds, activities and the device ops of the
    metrics' steps; the idle gaps of host_step."""
    busy = sum(busy_us([(d[1], d[2]) for d in s.device]) for s in steps)
    win = sum(s.window[1] - s.window[0] for s in steps)
    by_name: Dict[str, float] = {}
    for s in steps:
        for n, a, b in s.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    gaps: Dict[str, float] = {}
    for sec, n in idle_gaps(host_step):
        gaps[n] = gaps.get(n, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": win * 1e-6,
            "activities": sum(len(s.device) for s in steps),
            "splat_device_s": sum((b - a) * 1e-6 for s in steps
                                  for n, a, b in s.device
                                  if any(k in n for k in SPLAT_KERNELS)),
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in top_gaps]}

