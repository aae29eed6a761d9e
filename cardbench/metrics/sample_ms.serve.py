"""Milliseconds a decode step spends on the host after its logits
arrive: sampling every row, positions and tokens, evictions.  The
program's ``serve.sample`` span (``repro_torch.launch.spans``), its
process sum over its count.  ``None`` where the program keeps no
spans."""


def read(run):
    try:
        from repro_torch.launch import spans
    except ImportError:
        return None
    n, s = spans.sums().get("serve.sample", (0, 0.0))
    return 1e3 * s / n if n else None
