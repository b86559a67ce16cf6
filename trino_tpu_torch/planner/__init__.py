"""Logical planner & optimizer.

Reference parity: core/trino-main sql/planner/ (LogicalPlanner.java:196, plan
node classes in plan/, iterative rule engine, AddExchanges, PlanFragmenter).
"""

from trino_tpu_torch.planner.nodes import *  # noqa: F401,F403
from trino_tpu_torch.planner.planner import LogicalPlanner  # noqa: F401
