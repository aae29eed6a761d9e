"""Milliseconds an admission group's one-pass prefill takes (the whole
group's prompts in one full-sequence pass that writes their k/v into
the slots' caches): the program's ``serve.prefill`` span
(``repro_torch.launch.spans``), its process sum over its count, less
the spans inside which the traced run's profiler started or stopped
(``serve.prefill.profiler``; see ``launch_ms.serve``).  ``None`` where
the program keeps no such span (a program that admits by side steps
only)."""


def read(run):
    try:
        from repro_torch.launch import spans
    except ImportError:
        return None
    sums = spans.sums()
    n, s = sums.get("serve.prefill", (0, 0.0))
    _, held = sums.get("serve.prefill" + spans.PROFILER, (0, 0.0))
    return 1e3 * (s - held) / n if n else None
