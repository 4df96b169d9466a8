"""The paper's gradient-aggregation stack: fusion, the ReduceSchedule
plan, explicit ring/RHD schedules with wire codecs, over process groups."""
from .aggregator import AggregatorConfig, GradientAggregator
from .dist import Group

__all__ = ["AggregatorConfig", "GradientAggregator", "Group"]
