"""Arithmetic shared by the per-layer metric files in ``metrics/``.

Each reads the traced window's summary (``tracing.summarize``) with the
driver's counts: ``units`` (batches or steps completed in the window),
``images``, and what the driver adds (a kernel's bound a unit, FLOPs an
image, the peak). Each returns ``None`` where the window holds nothing
to read, and the metric is then left out of the line.
"""

from __future__ import annotations


def span_ms_per_unit(s: dict, name: str):
    """A host span's time a unit, in ms (a span opened twice a unit is
    summed)."""
    spans = s.get("spans", {}).get(name)
    if not spans or not s.get("units"):
        return None
    return sum(spans) / s["units"] * 1e3


def category_ms_per_unit(s: dict, *categories: str):
    """Device time of the categories a unit, in ms."""
    cat = s.get("category_s", {})
    if not s.get("units") or not any(c in cat for c in categories):
        return None
    return sum(cat.get(c, 0.0) for c in categories) / s["units"] * 1e3


def exposed_collective_ms_per_unit(s: dict):
    """Collective device time that no other operation overlaps, a unit,
    in ms; ``None`` where the window ran no collective."""
    if not s.get("units") or "collective" not in s.get("category_s", {}):
        return None
    return s["collective_exposed_s"] / s["units"] * 1e3


def roofline_pct(s: dict, category: str, bound_key: str):
    """A kernel's bound for the units over its device time, in percent."""
    t = s.get("category_s", {}).get(category)
    if not t or s.get(bound_key) is None or not s.get("units"):
        return None
    return s[bound_key] * s["units"] / t * 100.0


def mfu_pct(s: dict):
    """The FLOPs of the images completed, over the window at the peak."""
    if not s.get("images") or not s.get("window_s"):
        return None
    return (s["flops_per_image"] * s["images"] / s["window_s"]
            / s["peak_flops"] * 100.0)


def idle_pct(s: dict):
    """The share of the window with no device operation running."""
    if not s.get("window_s") or "busy_s" not in s:
        return None
    return (1.0 - s["busy_s"] / s["window_s"]) * 100.0
