"""The port's four lint passes (see each module's docstring for the bug
class it encodes)."""

from .cache_coherence import CacheCoherencePass
from .determinism import DeterminismPass
from .host_sync import HostSyncPass
from .telemetry import TelemetryStrictnessPass

__all__ = [
    "CacheCoherencePass",
    "DeterminismPass",
    "HostSyncPass",
    "TelemetryStrictnessPass",
]
