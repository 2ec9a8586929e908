from .base import BasePipeline, SummaryLogger
from .simulator import Simulator

PIPELINES = {"Simulator": Simulator}

__all__ = ["BasePipeline", "Simulator", "SummaryLogger", "PIPELINES"]
