from .sim import SimCluster, SafetyChecker

__all__ = ["SimCluster", "SafetyChecker"]
