"""Fault injection for the port's serving path (``failpoint``), copied
from ``tpu_dra/resilience``."""
