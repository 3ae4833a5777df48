from .scheduler import SimCluster, SimScheduler, SimTransport, simulated

__all__ = ["SimCluster", "SimScheduler", "SimTransport", "simulated"]
