from .mc import MC, MCAnalysis, MCParameters

__all__ = ["MC", "MCAnalysis", "MCParameters"]
