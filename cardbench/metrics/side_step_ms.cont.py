"""Milliseconds an admission side step takes (one token of a prefill
group's prompts, replayed over the group): the program's
``serve.side_steps`` span (``repro_torch.launch.spans``), whose count
is the side steps run, less the spans inside which the traced run's
profiler started or stopped (``serve.side_steps.profiler``; see
``launch_ms.serve``).  ``None`` where the program keeps no spans."""


def read(run):
    try:
        from repro_torch.launch import spans
    except ImportError:
        return None
    sums = spans.sums()
    n, s = sums.get("serve.side_steps", (0, 0.0))
    _, held = sums.get("serve.side_steps" + spans.PROFILER, (0, 0.0))
    return 1e3 * (s - held) / n if n else None
