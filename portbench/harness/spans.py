"""The program's own spans, for the ``program_span`` readers: the port's
``utils.profiling.span_stats()``, read in the process that ran the traced
window (rank 0 on several chips). The port records spans only while a
profiler records, so the record holds the traced window alone. A port
without spans gives nothing, and its readers None."""

from __future__ import annotations


def stats() -> dict:
    from pointnet2_tpu_torch.utils import profiling

    read = getattr(profiling, "span_stats", None)
    return read() if read is not None else {}


def ms_per(name: str, over: str, count: str | None = None) -> float | None:
    """Milliseconds of span ``name`` in all, over how often span ``over``
    ran, or over its summed count ``count``; None where either is
    missing."""
    s = stats()
    if name not in s or over not in s:
        return None
    n = s[over]["counts"].get(count) if count else s[over]["count"]
    return 1e3 * s[name]["total_s"] / n if n else None
