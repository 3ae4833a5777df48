"""Adaptive control plane: the observe/decide/actuate loop closing
over the telemetry substrate (service/metrics, service/history). Peer
of `service/` (which observes) and `analysis/` (which checks): this package DECIDES —
and actuates exclusively through the existing hot-reload knob machinery
and strategy re-selection seams, never through side-doors.
"""
from .loop import AdaptiveCompactionController  # noqa: F401
