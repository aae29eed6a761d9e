"""Milliseconds a decode step spends copying its inputs into the step
graph's static buffers and launching the replay: the program's
``serve.launch`` span (``repro_torch.launch.spans``), its process sum
over its count, less the spans inside which the traced run's profiler
started or stopped (``serve.launch.profiler``: the tracer ticks at the
step boundary, inside the span, and its start-up and tear-down take
seconds).  ``None`` where the program keeps no spans."""


def read(run):
    try:
        from repro_torch.launch import spans
    except ImportError:
        return None
    sums = spans.sums()
    n, s = sums.get("serve.launch", (0, 0.0))
    _, held = sums.get("serve.launch" + spans.PROFILER, (0, 0.0))
    return 1e3 * (s - held) / n if n else None
