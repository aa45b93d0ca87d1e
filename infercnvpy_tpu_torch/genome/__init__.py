"""Genome index layer: chromosome ordering + window planning."""

from .plan import WindowPlan, build_window_plan, natural_sort

__all__ = ["WindowPlan", "build_window_plan", "natural_sort"]
